// Forward zzrx kernels for Hopper (sm_90a): one TFIM layer (K1) and the
// whole L-layer stack (K2) on the (r, 128) float32 plane pair of a
// complex64 statevector.  Layout index = row * 128 + lane; qubit q is bit
// n-1-q of the flat index.
//
// K1 tcng_zzrx_fwd replaces kernels_rowlayer._pallas_zzrx_fwd
//    (_zzrx_fwd_kernel, _butterfly_rx, _lane_fwd_epilogue): zz phase
//    exp(-i/2 sum_k th_k Z_a Z_b) over all n qubits, rx on the nkernel
//    in-block row bits, then optionally y = x @ M with the 128x128 lane
//    matrix M.  With the (R, R) row-kron planes M7 (the FUSE_ROWM branch,
//    kernels_rowlayer._rowm_fwd_stage) the row stage runs only the low
//    nkernel - rmx butterflies and stage K13 (rowm.cuh) applies M7 to the
//    top rmx row bits of each block before the lane product.
// K2 tcng_grand_zzrx_fwd replaces kernels_grand.grand_zzrx_fwd
//    (_grand_fwd_kernel): L layers of K1-with-lane, each followed by the
//    outer (D, D) left-matmul across the G = D row blocks, streaming out
//    the post-lane, pre-outer residual ks[l].
//
// Design of K1.  A Pallas block holds RB = 2^nkernel rows x 128 lanes (1
// MB at RB = 1024), far above a CTA's 227 KB of shared memory, and the row
// butterflies need every row of a lane while the lane matmul needs every
// lane of a row.  So K1 is one layer of K2 without the outer pass, on the
// same stages of adjoint_stages.cuh:
//   row stage (fwd_row_stage on row_stage_plan(nrb, 7, nkernel - rmx)):
//     the phase over all n qubits (pair records sorted once a call) and the
//     low 6 walked bits in one pass, the high ones in a second, in place (at
//     n = 20, nkernel = 10: 6 + 4 bits, 512 CTAs of 256 threads; under the
//     row kron, rmx = 7: 3 bits in the zz pass alone, no shared-memory
//     exchange).  Without the lane it writes y; with it a scratch plane
//     pair, since the product may not alias its input;
//   K13 (rowm_apply<false>, rowm.cuh), with M7: the top rmx row bits of each
//     block as one (R, R) left product, in place on the row stage's output;
//   lane product (wide_nt_kernel<1, false>), with the lane: the scratch
//     planes @ M into y, on M^T transposed once a call.
// The caller's sr/si are never written.  Scratch: the pair records, and
// with the lane M^T's planes and the plane pair.
// Bound of K1 at n = 20 with the lane: operations, the lane product (1.07
// GFLOP, 16.0 us at 67 TFLOP/s float32 outside the tensor cores); without
// it bytes, the state's 16.8 MB in and out (5.0 us).
//
// Design of K2.  One C entry point launches three stages a layer on the
// caller's stream (the outer stage mixes blocks, so each layer needs a
// grid-wide dependency), on the stages of adjoint_stages.cuh that K9 runs:
//   row stage (fwd_row_stage on row_stage_plan(nrb, 7, nkernel), the plan
//     of K4's row stage): tiles of 2^11 elements with 32 consecutive lanes
//     a warp (whole 32-byte sectors), 8 elements a thread in registers; the
//     phase (pair records sorted once a call, the layer's angles joined in
//     the pass, sincospif) and the low 6 walked bits in one pass, the high
//     ones in a second, in place (at n = 20: 6 + 4 bits, 512 CTAs of 256
//     threads).  The phase comes before the rx gates of the layer, as in the
//     JAX kernel; the rx gates act on distinct bits and commute, so only
//     rounding differs from the JAX order;
//   lane product (wide_nt_kernel<1, false>): the row stage's output @ M_l
//     into the residual ks[l], on M^T transposed once a call for all L
//     layers (64 x 64 tiles, 4 x 4 micro-tiles a thread, double-buffered
//     cp.async chunks; 256 CTAs at n = 20);
//   outer pass (outer_fwd_kernel<D>): ks[l] -> y, one thread an in-block
//     position holding its D elements in registers, consecutive threads on
//     consecutive positions.
// The row stage runs from the caller's planes (layer 0) or y into y, so the
// caller's sr/si are never written; scratch holds the pair records and M^T.
// Bound of K2 at n = 20, L = 4: operations, the lane product (1.07 GFLOP a
// layer, 16.0 us); the row stage moves 16.8 MB a layer (5.0 us) and the
// outer pass 16.8 MB (5.0 us).  Plain f32 FMAs, no fast-math.

#include "adjoint_stages.cuh"
#include "rowm.cuh"

namespace {

// K2's largest outer dim: D <= 32
constexpr int MAX_D = 32;

// K2's outer pass on one in-block position p a thread: y[m] = sum_k
// mo[m][k] ks[k] over the D row blocks of be positions each.
template <int D>
__global__ void __launch_bounds__(THREADS)
outer_fwd_kernel(const float* __restrict__ kr, const float* __restrict__ ki, float* yr,
                 float* yi, const float* __restrict__ mor, const float* __restrict__ moi,
                 long be) {
  __shared__ float m_r[D * D], m_i[D * D];
  for (int e = threadIdx.x; e < D * D; e += blockDim.x) {
    m_r[e] = mor[e];
    m_i[e] = moi[e];
  }
  __syncthreads();
  const long p = static_cast<long>(blockIdx.x) * THREADS + threadIdx.x;
  if (p >= be) return;
  float x_r[D], x_i[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    x_r[k] = kr[k * be + p];
    x_i[k] = ki[k * be + p];
  }
#pragma unroll
  for (int m = 0; m < D; ++m) {
    float sr = 0.f, si = 0.f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float wr = m_r[m * D + k], wi = m_i[m * D + k];
      sr = fmaf(-wi, x_i[k], fmaf(wr, x_r[k], sr));
      si = fmaf(wi, x_r[k], fmaf(wr, x_i[k], si));
    }
    yr[m * be + p] = sr;
    yi[m * be + p] = si;
  }
}

template <int D>
const void* outer_fwd_fn() {
  return reinterpret_cast<const void*>(outer_fwd_kernel<D>);
}

// The outer pass's kernel for D (1..MAX_D, a power of two), else null.
const void* outer_fwd_for(int d) {
  switch (d) {
    case 1: return outer_fwd_fn<1>();
    case 2: return outer_fwd_fn<2>();
    case 4: return outer_fwd_fn<4>();
    case 8: return outer_fwd_fn<8>();
    case 16: return outer_fwd_fn<16>();
    case 32: return outer_fwd_fn<32>();
    default: return nullptr;
  }
}

struct GrandPlan {
  int r, d;
  long be;         // in-block positions: the outer pass's threads
  RowStage rs;     // the row stage: the nkernel low row bits walked
};

// false for a shape K2 does not take: r = 2^nrb rows, D = r >> nkernel in
// 1..MAX_D, and the row stage's shapes.
bool grand_plan(int r, int nkernel, int npairs, GrandPlan* p) {
  const int nrb = ilog2(r);
  if (r < 1 || r != 1 << nrb || nkernel < 0 || nkernel > nrb || npairs < 0) return false;
  p->r = r;
  p->d = r >> nkernel;
  if (p->d > MAX_D || !row_stage_plan(nrb, ilog2(LANES), nkernel, &p->rs)) return false;
  p->be = static_cast<long>(LANES) << nkernel;
  return true;
}

unsigned outer_grid(const GrandPlan& p) { return static_cast<unsigned>((p.be + THREADS - 1) / THREADS); }

// The outer pass of one layer, ks -> y, with the layer's (D, D) planes.
cudaError_t outer_fwd(const GrandPlan& p, const float* kr, const float* ki, float* yr, float* yi,
                      const float* mor, const float* moi, cudaStream_t st) {
  long be = p.be;
  void* args[] = {&kr, &ki, &yr, &yi, &mor, &moi, &be};
  return cudaLaunchKernel(outer_fwd_for(p.d), dim3(outer_grid(p)), dim3(THREADS), args, 0, st);
}

struct GrandScratch {
  float *rec, *mtr, *mti;
};

// Floats of K2's scratch: the pair records and M^T's two planes; fills s
// when base is given.
size_t grand_layout(int npairs, int L, float* base, GrandScratch* s) {
  const size_t sizes[3] = {pair_record_floats(npairs), static_cast<size_t>(L) * MM,
                           static_cast<size_t>(L) * MM};
  float* ptrs[3];
  const size_t off = carve(sizes, base, ptrs);
  if (s) *s = GrandScratch{ptrs[0], ptrs[1], ptrs[2]};
  return off;
}

// The records of the forward row stage's zz pass (first: the last pass's
// tiles) and its other pass (x1 = tile elements, x2 = the pass's row bits;
// 0 CTAs with one pass) into out[0..16), as K1 and K2 report them.
cudaError_t fwd_pass_records(const RowStage& rs, int npairs, long* out) {
  cudaError_t err = cudaSuccess;
  for (int k = 0; k < 2 && err == cudaSuccess; ++k) {
    const bool zz = k == 0;
    const RowPass& rp = zz ? last_pass(rs) : rs.pass[0];
    const bool runs = zz || rs.npass == 2;
    err = kernel_record(fwd_pass_fn(zz), runs ? row_ctas(rs) : 0, row_threads(rs),
                        fwd_pass_smem(rp, npairs, zz), 1L << rp.tb, runs ? rp.nb : 0, out + 8 * k);
  }
  return err;
}

// K1's largest row kron: rmx <= 7 (rowm.cuh's R = 2..128)
constexpr int MAX_RMX = 7;

// K1's row stage, which walks the low nkernel - rmx row bits; false for a
// shape K1 does not take: r = 2^nrb rows, 0 <= rmx <= min(nkernel, 7),
// nkernel <= nrb, and the row stage's shapes.
bool k1_plan(int r, int nkernel, int npairs, int rmx, RowStage* rs) {
  const int nrb = ilog2(r);
  if (r < 1 || r != 1 << nrb || nkernel > nrb || npairs < 0 || rmx < 0 || rmx > nkernel || rmx > MAX_RMX)
    return false;
  return row_stage_plan(nrb, ilog2(LANES), nkernel - rmx, rs);
}

struct K1Scratch {
  float *rec, *mtr, *mti, *tr, *ti;
};

// Floats of K1's scratch: the pair records and, with the lane, M^T's two
// planes and the row stage's output planes; fills s when base is given.
size_t k1_layout(int r, int npairs, bool lane, float* base, K1Scratch* s) {
  const size_t plane = lane ? static_cast<size_t>(r) * LANES : 0, mm = lane ? MM : 0;
  const size_t sizes[5] = {pair_record_floats(npairs), mm, mm, plane, plane};
  float* ptrs[5];
  const size_t off = carve(sizes, base, ptrs);
  if (s) *s = K1Scratch{ptrs[0], ptrs[1], ptrs[2], ptrs[3], ptrs[4]};
  return off;
}

}  // namespace

extern "C" {

const char* tcng_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of scratch tcng_zzrx_fwd needs for these shapes; -1 for a shape
// it does not take.
long tcng_zzrx_fwd_scratch(int r, int nkernel, int npairs, int lane, int rmx) {
  RowStage rs;
  if (!k1_plan(r, nkernel, npairs, rmx, &rs)) return -1;
  return static_cast<long>(k1_layout(r, npairs, lane != 0, nullptr, nullptr));
}

// K1's stage kernels' plan at these shapes, for the record: four records
// of 8 (kernel_record): the row stage's zz pass (first) and its other pass
// (x1 = tile elements, x2 = the pass's row bits; 0 CTAs with one pass), the
// transpose of M (x1 = 1 layer, x2 = 2 planes; CTAs a launch) and the lane
// product (x1, x2 = the tile's rows and columns), both 0 CTAs without the
// lane.  K13's record is tcng_rowm_fwd_plan's.
int tcng_zzrx_fwd_plan(int r, int nkernel, int npairs, int lane, int rmx, long* out) {
  RowStage rs;
  if (!k1_plan(r, nkernel, npairs, rmx, &rs)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = fwd_pass_records(rs, npairs, out);
  if (err == cudaSuccess)
    err = kernel_record(reinterpret_cast<const void*>(transpose_kernel), lane ? 16 : 0, 256, 0, 1, 2,
                        out + 16);
  if (err == cudaSuccess)
    err = kernel_record(reinterpret_cast<const void*>(wide_nt_kernel<1, false>), lane ? prod_ctas(r, 7) : 0,
                        THREADS, prod_smem<1>(), P_T, P_T, out + 24);
  return static_cast<int>(err);
}

// K1.  sr/si, yr/yi: (r, 128) planes, r = 2^nrb (y may alias s without
// the lane; s is not written unless it is y); zzth (npairs); shifts
// (npairs, 2) = (n-1-a, n-1-b); th (nkernel); mr/mi (128, 128) lane planes
// or null; m7r/m7i (R, R) row-kron planes with R = 2^rmx, or null with rmx
// = 0 (then th[0..rmx) is not read); scratch of tcng_zzrx_fwd_scratch
// floats.  The scratch, m7r/m7i and (without the lane, under the row kron)
// y are 16-byte aligned.  Returns the first CUDA error
// (cudaErrorInvalidValue for a shape it does not take), 0 on success.
int tcng_zzrx_fwd(const float* sr, const float* si, float* yr, float* yi,
                  const float* zzth, const int* shifts, int npairs,
                  const float* th, int nkernel, const float* mr,
                  const float* mi, const float* m7r, const float* m7i,
                  int rmx, float* scratch, int r, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RowStage rs;
  if (!k1_plan(r, nkernel, npairs, rmx, &rs)) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(scratch)) return static_cast<int>(cudaErrorMisalignedAddress);
  const bool lane = mr != nullptr;
  K1Scratch s;
  k1_layout(r, npairs, lane, scratch, &s);
  // the product may not alias its input: with the lane the row stage and
  // K13 write the scratch planes
  float* xr = lane ? s.tr : yr;
  float* xi = lane ? s.ti : yi;
  cudaError_t err = fwd_stage_prepare(rs, npairs);
  if (err == cudaSuccess) err = pair_records(rs, shifts, npairs, s.rec, st);
  if (err == cudaSuccess && lane) {
    err = set_smem(reinterpret_cast<const void*>(wide_nt_kernel<1, false>), prod_smem<1>());
    // M^T once a call: the product reads its b operand as b[n][k]
    if (err == cudaSuccess) err = transpose_planes(mr, mi, s.mtr, s.mti, 1, 7, st);
  }
  if (err == cudaSuccess) err = fwd_row_stage(rs, sr, si, xr, xi, s.rec, zzth, npairs, th + rmx, st);
  if (err == cudaSuccess && rmx > 0)  // K13, in place
    err = rowm_apply<false>(xr, xi, nullptr, nullptr, xr, xi, nullptr, nullptr, m7r, m7i, r, nkernel, rmx, st);
  if (err == cudaSuccess && lane)
    err = wide_nt<1, false>(xr, xi, nullptr, nullptr, s.mtr, s.mti, yr, yi, nullptr, nullptr, r, 7, st);
  return static_cast<int>(err);
}

// K13's plan at these shapes, for the record: out[0..7) = CW, tiles,
// grid, shared bytes, CTAs an SM, registers, local bytes.
int tcng_rowm_fwd_plan(int rmx, int r, long* out) {
  return static_cast<int>(rowm_apply_plan<false>(rmx, r, out));
}

// Floats of scratch tcng_grand_zzrx_fwd needs for these shapes; -1 for a
// shape it does not take.
long tcng_grand_zzrx_fwd_scratch(int r, int nkernel, int npairs, int L) {
  GrandPlan p;
  if (L < 1 || !grand_plan(r, nkernel, npairs, &p)) return -1;
  return static_cast<long>(grand_layout(npairs, L, nullptr, nullptr));
}

// K2's stage kernels' plan at these shapes, for the record: five records of
// 8 (kernel_record: CTAs, threads, shared bytes, CTAs an SM, registers,
// local bytes, x1, x2): the row stage's zz pass (the last pass's tiles,
// first) and its other pass (x1 = tile elements, x2 = the pass's row bits;
// 0 CTAs with one pass), the lane product (x1, x2 = the tile's rows and
// columns), the outer pass (x1 = D, x2 = nouter) and the transpose of M (x1
// = L, x2 = the planes; CTAs a launch).
int tcng_grand_zzrx_fwd_plan(int r, int nkernel, int npairs, int L, long* out) {
  GrandPlan p;
  if (L < 1 || !grand_plan(r, nkernel, npairs, &p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = fwd_pass_records(p.rs, npairs, out);
  if (err == cudaSuccess)
    err = kernel_record(reinterpret_cast<const void*>(wide_nt_kernel<1, false>), prod_ctas(r, 7),
                        THREADS, prod_smem<1>(), P_T, P_T, out + 16);
  if (err == cudaSuccess)
    err = kernel_record(outer_fwd_for(p.d), outer_grid(p), THREADS, 0, p.d, ilog2(p.d), out + 24);
  if (err == cudaSuccess)
    err = kernel_record(reinterpret_cast<const void*>(transpose_kernel), 16L * L, 256, 0, L, 2,
                        out + 32);
  return static_cast<int>(err);
}

// K2.  sr/si (r, 128) input planes, r = 2^nrb; ksr/ksi (L, r, 128)
// residuals; yr/yi (r, 128) output; zzth (L, npairs); shifts (npairs, 2) =
// (n-1-a, n-1-b); th (L, nkernel); mor/moi (L, D, D) with D = r >> nkernel
// <= 32; mlr/mli (L, 128, 128); scratch of tcng_grand_zzrx_fwd_scratch
// floats; ks, y and the scratch 16-byte aligned.  sr/si are not written.
int tcng_grand_zzrx_fwd(const float* sr, const float* si, float* ksr,
                        float* ksi, float* yr, float* yi, const float* zzth,
                        const int* shifts, int npairs, const float* th,
                        int nkernel, int L, const float* mor,
                        const float* moi, const float* mlr, const float* mli,
                        float* scratch, int r, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GrandPlan p;
  // the one check of the outer dim (grand_plan: D <= 32)
  if (L < 1 || !grand_plan(r, nkernel, npairs, &p)) return static_cast<int>(cudaErrorInvalidValue);
  if (!all_aligned16({ksr, ksi, yr, yi, scratch})) return static_cast<int>(cudaErrorMisalignedAddress);
  GrandScratch s;
  grand_layout(npairs, L, scratch, &s);
  cudaError_t err = fwd_stage_prepare(p.rs, npairs);
  if (err == cudaSuccess)
    err = set_smem(reinterpret_cast<const void*>(wide_nt_kernel<1, false>), prod_smem<1>());
  // the zz pass's pair records and M^T, once a call for every layer
  if (err == cudaSuccess) err = pair_records(p.rs, shifts, npairs, s.rec, st);
  if (err == cudaSuccess) err = transpose_planes(mlr, mli, s.mtr, s.mti, L, 7, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t plane = static_cast<size_t>(r) * LANES;
  const int dd = p.d * p.d;
  for (int l = 0; l < L; ++l) {
    float* kr = ksr + l * plane;
    float* ki = ksi + l * plane;
    err = fwd_row_stage(p.rs, l == 0 ? sr : yr, l == 0 ? si : yi, yr, yi, s.rec, zzth + l * npairs,
                        npairs, th + l * nkernel, st);
    if (err == cudaSuccess)
      err = wide_nt<1, false>(yr, yi, nullptr, nullptr, s.mtr + l * MM, s.mti + l * MM, kr, ki,
                              nullptr, nullptr, r, 7, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = outer_fwd(p, kr, ki, yr, yi, mor + l * dd, moi + l * dd, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
