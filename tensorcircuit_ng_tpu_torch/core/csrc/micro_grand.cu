// K15 tcng_micro_grand for Hopper (sm_90a): the staged micro-benchmark of
// K2's design.  Replaces examples/micro_grand_fusion.py run_micro
// (_micro_kernel) at its shapes: L layers over (r, 128) float32 planes,
// r = D * RB with RB = 1024 rows a block (10 row qubits) and D blocks
// (n = 20: D = 8).  Layout index = row * 128 + lane.
//
//   level 1 (m1): each layer copies the state to the other buffer;
//   level 2 (m2): each layer applies the 10 raw-(c, s) butterflies
//     [[c, -i s], [-i s, c]] to each block's rows, (c, s) = cs[l][q] on the
//     in-block row bit of stride RB >> (q + 1), then the lane product
//     y = x @ (mlr[l] + i mli[l]);
//   level 3 (m3): m2, then at the end of each layer the (D, D) complex
//     left-matmul by mo[l] across the D blocks.
// The output holds the last layer.  The inputs need not be unitary.
//
// Design.  The TPU kernel keeps the whole state in VMEM across its (L, D)
// grid; a CTA has 227 KB, so here each layer is passes over the state,
// which stays in the 50 MB L2 at n = 20 (8.4 MB a plane pair).  Levels 2
// and 3 run the stages of adjoint_stages.cuh that K6 with the lane and K2
// run, on the same layout (nkernel = 10):
//   once a call: the gates g[l][q] = [[c, -i s], [-i s, c]] as (L, 10, 4)
//     planes gr = (c, 0, 0, c), gi = (0, -s, -s, 0) (micro_gates_kernel),
//     and M_l^T for all L layers (transpose_planes);
//   row stage (bfly_row_stage<true, false> on row_stage_plan(nrb, 7, 10),
//     K6's passes): the low 6 row bits of each block, then the high 4 in
//     place (512 CTAs of 256 threads each at n = 20);
//   lane product (wide_nt_kernel<1, false> on M_l^T), out of place;
//   outer pass (m3: outer_fwd_kernel<D>, K2's), out of place.
// Two plane pairs carry a layer, the output y and the scratch a, from x
// (the caller's planes at layer 0, never written; y after it): m2 the row
// stage x -> a and the product a -> y; m3 the row stage x -> y, the
// product y -> a and the outer pass a -> y.  Level 1 copies x to y and a
// in turn (float4 loads and stores), the output holding the last layer.
// The gates act on distinct bits and commute, so the row stage takes them
// in another order than the TPU kernel (only rounding differs).  No sum
// crosses a CTA: two runs agree bit for bit.
// Bound at n = 20, L = 4: m1 bytes (the state in and out once, 16.8 MB,
// 5.0 us); m2 and m3 operations (the lane product, 8 * 128 flops an
// amplitude a layer, 64.1 us in all at 67 TFLOP/s float32).

#include "adjoint_stages.cuh"

namespace {

constexpr int RB = 1024;
constexpr int NBF = 10;  // butterflies: log2(RB)
constexpr int MAX_D = 16;

__global__ void __launch_bounds__(THREADS)
copy_kernel(const float4* xr, const float4* xi, float4* yr, float4* yi, long n4) {
  for (long e = blockIdx.x * static_cast<long>(THREADS) + threadIdx.x; e < n4;
       e += static_cast<long>(gridDim.x) * THREADS) {
    yr[e] = xr[e];
    yi[e] = xi[e];
  }
}

// The ng gates of K6's kind from the raw (c, s) = cs[g]: gr[g] = (c, 0, 0,
// c), gi[g] = (0, -s, -s, 0), entries (g00, g01, g10, g11).
__global__ void __launch_bounds__(THREADS)
micro_gates_kernel(const float* __restrict__ cs, float4* gr, float4* gi, int ng) {
  const int g = blockIdx.x * THREADS + threadIdx.x;
  if (g >= ng) return;
  const float c = cs[2 * g], s = cs[2 * g + 1];
  gr[g] = make_float4(c, 0.f, 0.f, c);
  gi[g] = make_float4(0.f, -s, -s, 0.f);
}

struct MicroPlan {
  int d;         // row blocks
  long be;       // in-block positions: the outer pass's threads
  RowStage rs;   // levels 2 and 3: the 10 low row bits walked
};

// false for a shape K15 does not take: L >= 1 and r = D * RB with D in
// 1..MAX_D; at levels 2 and 3 r a power of two; at level 3 D >= 2.
bool micro_plan(int level, int r, int L, MicroPlan* p) {
  if (level < 1 || level > 3 || L < 1 || r < RB || r % RB || r / RB > MAX_D) return false;
  p->d = r / RB;
  p->be = static_cast<long>(RB) * LANES;
  p->rs = RowStage{};
  if (level == 1) return true;
  const int nrb = ilog2(r);
  if (r != 1 << nrb || (level == 3 && p->d < 2)) return false;
  return row_stage_plan(nrb, ilog2(LANES), NBF, &p->rs);
}

unsigned gate_ctas(int L) { return static_cast<unsigned>((L * NBF + THREADS - 1) / THREADS); }
long copy_vectors(int r) { return static_cast<long>(r) * LANES / 4; }
unsigned copy_ctas(int r) { return static_cast<unsigned>((copy_vectors(r) + THREADS - 1) / THREADS); }

struct MicroScratch {
  float *gr, *gi, *mtr, *mti;
};

// Floats of K15's scratch at levels 2 and 3 (none at level 1): the gate
// planes and M^T's planes for L layers; fills s when base is given.
size_t micro_layout(int level, int L, float* base, MicroScratch* s) {
  const size_t g = level >= 2 ? static_cast<size_t>(4) * NBF * L : 0;
  const size_t mm = level >= 2 ? static_cast<size_t>(L) * MM : 0;
  const size_t sizes[4] = {g, g, mm, mm};
  float* ptrs[4];
  const size_t off = carve(sizes, base, ptrs);
  if (s) *s = MicroScratch{ptrs[0], ptrs[1], ptrs[2], ptrs[3]};
  return off;
}

// A stage's record (kernel_record) when it runs at this level, else 8 zeros.
cudaError_t stage_record(bool runs, const void* kern, long ctas, int threads, size_t smem, long x1,
                         long x2, long* out) {
  if (runs) return kernel_record(kern, ctas, threads, smem, x1, x2, out);
  for (int i = 0; i < 8; ++i) out[i] = 0;
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* tcng_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of scratch tcng_micro_grand needs for these shapes; -1 for a
// shape it does not take.
long tcng_micro_grand_scratch(int level, int r, int L) {
  MicroPlan p;
  if (!micro_plan(level, r, L, &p)) return -1;
  return static_cast<long>(micro_layout(level, L, nullptr, nullptr));
}

// K15's stage kernels' plan at these shapes, for the record: seven records
// of 8 (kernel_record: CTAs, threads, shared bytes, CTAs an SM, registers,
// local bytes, x1, x2), in launch order: the gate build (x1 = L, x2 = the
// gates a layer), the transpose of M (x1 = L, x2 = the planes; CTAs a
// launch), the row stage's low pass and its high pass (x1 = tile
// elements, x2 = the pass's row bits), the lane product (x1, x2 = the
// tile's rows and columns), the outer pass (x1 = D, x2 = log2 D) and the
// copy pass (x1 = float4 vectors a plane, x2 = the planes).  A stage that
// the level does not run has 8 zeros.
int tcng_micro_grand_plan(int level, int r, int L, long* out) {
  MicroPlan p;
  if (!micro_plan(level, r, L, &p)) return static_cast<int>(cudaErrorInvalidValue);
  const bool rows = level >= 2;
  const RowStage& rs = p.rs;
  const void* pass = reinterpret_cast<const void*>(fwd_row_pass_kernel<false, true, false>);
  cudaError_t err = stage_record(rows, reinterpret_cast<const void*>(micro_gates_kernel), gate_ctas(L),
                                 THREADS, 0, L, NBF, out);
  if (err == cudaSuccess)
    err = stage_record(rows, reinterpret_cast<const void*>(transpose_kernel), 16L * L, 256, 0, L, 2, out + 8);
  // the low pass (the plan's last), then the high one (the plan's first)
  for (int k = 0; k < 2 && err == cudaSuccess; ++k) {
    if (rows && (k == 0 || rs.npass == 2)) {
      const RowPass& rp = k == 0 ? last_pass(rs) : rs.pass[0];
      err = kernel_record(pass, row_ctas(rs), row_threads(rs), fwd_pass_smem(rp, 0, false, true),
                          1L << rp.tb, rp.nb, out + 16 + 8 * k);
    } else {
      err = stage_record(false, pass, 0, 0, 0, 0, 0, out + 16 + 8 * k);
    }
  }
  if (err == cudaSuccess)
    err = stage_record(rows, reinterpret_cast<const void*>(wide_nt_kernel<1, false>), prod_ctas(r, 7),
                       THREADS, prod_smem<1>(), P_T, P_T, out + 32);
  if (err == cudaSuccess)
    err = stage_record(level == 3, outer_fwd_for(p.d), outer_grid(p.be), THREADS, 0, p.d, ilog2(p.d),
                       out + 40);
  if (err == cudaSuccess)
    err = stage_record(level == 1, reinterpret_cast<const void*>(copy_kernel), copy_ctas(r), THREADS, 0,
                       copy_vectors(r), 2, out + 48);
  return static_cast<int>(err);
}

// K15.  level 1, 2 or 3; cs (L, 10, 2); mlr/mli (L, 128, 128); mor/moi
// (L, D, D) with D = r / 1024 (read at level 3 only); sr/si (r, 128) input
// planes; yr/yi (r, 128) output planes; ar/ai (r, 128) scratch planes;
// scratch of tcng_micro_grand_scratch floats (null at level 1).  The
// planes and the scratch are 16-byte aligned; sr/si are not written.
// Returns the first CUDA error (cudaErrorInvalidValue for a shape it does
// not take), 0 on success.
int tcng_micro_grand(int level, const float* cs, const float* mlr,
                     const float* mli, const float* mor, const float* moi,
                     const float* sr, const float* si, float* yr, float* yi,
                     float* ar, float* ai, float* scratch, int L, int r, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MicroPlan p;
  if (!micro_plan(level, r, L, &p)) return static_cast<int>(cudaErrorInvalidValue);
  if (!all_aligned16({sr, si, yr, yi, ar, ai}) || (level >= 2 && !aligned16(scratch)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err = cudaSuccess;
  const float *xr = sr, *xi = si;
  if (level == 1) {
    const long n4 = copy_vectors(r);
    for (int l = 0; l < L && err == cudaSuccess; ++l) {
      const bool to_out = (L - 1 - l) % 2 == 0;
      float* dr = to_out ? yr : ar;
      float* di = to_out ? yi : ai;
      copy_kernel<<<copy_ctas(r), THREADS, 0, st>>>(
          reinterpret_cast<const float4*>(xr), reinterpret_cast<const float4*>(xi),
          reinterpret_cast<float4*>(dr), reinterpret_cast<float4*>(di), n4);
      err = cudaGetLastError();
      xr = dr;
      xi = di;
    }
    return static_cast<int>(err);
  }
  MicroScratch s;
  micro_layout(level, L, scratch, &s);
  err = set_smem(reinterpret_cast<const void*>(wide_nt_kernel<1, false>), prod_smem<1>());
  // the gates and M^T once a call: the product reads its b operand as b[n][k]
  if (err == cudaSuccess) {
    micro_gates_kernel<<<gate_ctas(L), THREADS, 0, st>>>(cs, reinterpret_cast<float4*>(s.gr),
                                                         reinterpret_cast<float4*>(s.gi), L * NBF);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) err = transpose_planes(mlr, mli, s.mtr, s.mti, L, 7, st);
  // m2: the row stage x -> a, the product a -> y; m3: x -> y, y -> a, then
  // the outer pass a -> y
  float* rr = level == 2 ? ar : yr;
  float* ri = level == 2 ? ai : yi;
  float* pr = level == 2 ? yr : ar;
  float* pi = level == 2 ? yi : ai;
  const int dd = p.d * p.d;
  for (int l = 0; l < L && err == cudaSuccess; ++l) {
    const int g = l * 4 * NBF;
    err = bfly_row_stage<true, false>(p.rs, xr, xi, rr, ri, s.gr + g, s.gi + g, st);
    if (err == cudaSuccess)
      err = wide_nt<1, false>(rr, ri, nullptr, nullptr, s.mtr + static_cast<long>(l) * MM,
                              s.mti + static_cast<long>(l) * MM, pr, pi, nullptr, nullptr, r, 7, st);
    if (err == cudaSuccess && level == 3)
      err = outer_fwd(p.d, p.be, ar, ai, yr, yi, mor + l * dd, moi + l * dd, st);
    xr = yr;
    xi = yi;
  }
  return static_cast<int>(err);
}

}  // extern "C"
