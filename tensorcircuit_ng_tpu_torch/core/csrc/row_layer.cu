// Row-layer kernels for Hopper (sm_90a): one arbitrary 2x2 complex gate on
// each of the nkernel lowest row bits of the (r, 128) float32 plane pair of
// a complex64 statevector, its adjoint, and the adjoint for constant
// gates.  Layout index = row * 128 + lane; the rows split into blocks of
// RB = 2^nkernel, and gate q acts on the in-block bit of stride RB >> (q+1)
// (q = 0 the most significant).  Gates arrive as (nkernel, 4) real and
// imaginary planes, entries (g00, g01, g10, g11).
//
// Conventions (those of the JAX package): cotangent planes are
// (dL/dyr, -dL/dyi), the non-conjugating complex cotangent, and walk by
// the TRANSPOSE of each map; the gate cotangent is
// dg[q][a][b] = sum over rows with bit a of ct[r] * s[r with bit b], plain
// products, s the state before gate q.  Gates (and the lane matrix) are
// unitary, so the backward rebuilds every intermediate state from the
// layer's output by un-applying g^dagger.
//
// K6 tcng_row_fwd replaces kernels_rowlayer._pallas_row_fwd (_fwd_kernel,
//    _butterfly, _lane_fwd_epilogue): the nkernel butterflies, then
//    optionally y = x @ M with the 128x128 lane planes M.
// K7 tcng_row_bwd replaces kernels_rowlayer._pallas_row_bwd (_bwd_kernel,
//    _lane_bwd_prologue): from the output y and the cotangent ct, with the
//    lane: psi = y @ conj(M)^T, dM = psi^T ct, ct <- ct @ M^T; then per
//    gate: un-apply g^dagger, the four complex sums of dg, walk ct by g^T.
//    Returns ds = ct, dg (2, nkernel, 4) and dM.
// K8 tcng_row_bwd_const replaces kernels_rowlayer._pallas_row_bwd_const
//    (_const_bwd_kernel): the ct walk by g^T alone, gates in reverse.
// K11 tcng_rotx_fwd replaces kernels_rowlayer._pallas_rotx_fwd
//    (_rotx_fwd_kernel): rx(th_q) = [[c, -i s], [-i s, c]] on each kernel
//    row bit, the symmetric form of K6's butterfly (angles, not gates).
// K12 tcng_rotx_bwd replaces kernels_rowlayer._pallas_rotx_bwd
//    (_rotx_bwd_kernel): per bit in reverse the rx un-apply, dth_q =
//    -1/2 s Re S1 + 1/2 c Im S2 (S1 = sum ct.psi, S2 = sum pct.psi, pct
//    the partner rows' cotangent) and the ct walk by rx^T = rx: two sums a
//    qubit where K7 takes eight, and dth directly (no dgate -> dth chain).
//
// Design.  A TPU block holds RB x 128 lanes in VMEM: 2 MB at RB = 2048
// (nkernel = 11), nine times a CTA's 227 KB of shared memory.  K6, K8 and
// K11 take all RB rows of one block for TL = 8192 / RB lanes in shared
// memory (TL = 4 at nkernel = 11: a tile of 8192 complex elements, 64 KB
// for two planes), one barrier between gates; each row is then read as 16
// B of a 32-B sector.  K7 and K12 run on the row stage of
// adjoint_stages.cuh instead (the plan row_stage_plan(nrb, 7, nkernel)
// that K3, K4 and K10 use): tiles of 2^11 elements with 32 consecutive
// lanes a warp (whole sectors), the walked bits in at most two passes of
// at most 6 (at n = 20, nkernel = 11: the 5 high ones, then the 6 low
// ones, 512 CTAs of 256 threads each), a thread holding 8 elements of psi
// and ct in registers for 3 bits at a time.  K7 (gate_row_stage), per
// bit: un-apply g^dagger, the eight dg sums reduced over the warp at once
// by halving exchanges (warp_sum8), the ct walk by g^T.  K12
// (rx_row_stage): K10's rx butterflies without the zz stage, the first
// pass ml_row_pass_kernel<false> with no pairs, the last
// rx_row_pass_kernel (no pair records, phase or x planes); the two dth
// sums a bit go through a warp tree into one partial a CTA.  The gates act
// on distinct bits and commute, so K7 and K12 take them in another order
// than the JAX kernels (high pass first; only rounding differs).  K7 and
// K12 run on the caller's y and ct, which they do not write: the first of
// two passes writes psi to scratch and ct to ds, the last only ds.  With
// the lane (the fuse_lane route) K7 first runs the adjoint lane stage
// that K3, K4 and K10 share (the un-lane and ct walk in one launch, dM as
// split-K partials), psi into scratch and ct into ds, and the passes
// follow in place.  The dg and dth sums are one partial a CTA added by
// colsum_tree_kernel in a fixed order: no atomics, so K7 and K12 are
// bit-identical run to run.  K8 is K6's row pass walking the transposed
// gates in reverse.
// Bounds at n = 20, nkernel = 11, on the H100 (3.35 TB/s, 67 TFLOP/s
// float32): K6 without the lane moves 16.8 MB (two planes in, two out) for
// 0.16 GFLOP, 0.005 ms, bound by bytes; with the lane the 1.07 GFLOP of
// lane products bound it by operations (0.018 ms); K7 without the lane
// moves 25 MB for 0.5 GFLOP (0.0076 ms, operations); K8 as K6 (0.005 ms).
// At n = 20, nkernel = 10 (r = 8192), K11 moves 16.8 MB (0.005 ms, bytes)
// and K12 25 MB for 20 flops an amplitude a bit (0.0075 ms, bytes).
// Plain f32 FMAs, no fast-math.

#include "adjoint_stages.cuh"

namespace {

// row tile: RB * TL complex elements (8192: 64 KB of two planes)
constexpr int TILE_ELEMS = 8192;
// RB <= 2048 = TILE_ELEMS / 4 keeps at least 4 lanes a tile
constexpr int MAX_NKERNEL = 11;
// log2 of the lanes
constexpr int LANE_BITS = 7;

struct RowPlan {
  int rb, ltl, grid;
};

// false for a shape the kernels do not take: nkernel in [1, 11] and r a
// positive multiple of RB.
bool row_plan(int r, int nkernel, RowPlan* p) {
  if (nkernel < 1 || nkernel > MAX_NKERNEL || r <= 0) return false;
  p->rb = 1 << nkernel;
  if (r % p->rb) return false;
  int tl = TILE_ELEMS / p->rb;
  if (tl > LANES) tl = LANES;
  p->ltl = ilog2(tl);
  p->grid = (r / p->rb) * (LANES >> p->ltl);
  return true;
}

// Dynamic shared memory of a row kernel: `planes` tile planes, the gates
// (8 floats a gate) and `extra` floats.
size_t row_smem(int planes, int nkernel, int extra) {
  return sizeof(float) * (static_cast<size_t>(planes) * TILE_ELEMS + 8 * nkernel + extra);
}

// Tile element e of CTA blockIdx.x: its offset in the planes.
__device__ __forceinline__ long tile_off(int e, int ltl, int rb) {
  const int tiles = LANES >> ltl;
  const long j = blockIdx.x / tiles;  // row block
  const int lane0 = (blockIdx.x % tiles) << ltl;
  return (j * rb + (e >> ltl)) * LANES + lane0 + (e & ((1 << ltl) - 1));
}

// Pair p of the stage on the in-block bit of stride 2^ls: the tile
// elements of its bit-0 row (elo) and bit-1 row (ehi), same lane.
__device__ __forceinline__ void pair_elems(int p, int ls, int ltl, int* elo,
                                           int* ehi) {
  const int pr = p >> ltl;
  const int lo = ((pr >> ls) << (ls + 1)) | (pr & ((1 << ls) - 1));
  *elo = (lo << ltl) | (p & ((1 << ltl) - 1));
  *ehi = *elo + (1 << (ls + ltl));
}

// gates (nkernel, 4) re/im planes -> g[8q + 2e + {0, 1}] = (re, im) of
// entry e of gate q.
__device__ __forceinline__ void load_gates(float* g, const float* gr,
                                           const float* gi, int nkernel) {
  for (int k = threadIdx.x; k < 4 * nkernel; k += blockDim.x) {
    g[2 * k] = gr[k];
    g[2 * k + 1] = gi[k];
  }
}

// K6's row pass (WALK = false): gate q = 0..nkernel-1 on its bit.  K8
// (WALK = true): the transpose of gate q = nkernel-1..0.  x and y may alias.
template <bool WALK>
__global__ void __launch_bounds__(THREADS)
row_apply_kernel(const float* xr, const float* xi, float* yr, float* yi,
                 const float* __restrict__ gr, const float* __restrict__ gi,
                 int nkernel, int ltl) {
  extern __shared__ float smem[];
  const int rb = 1 << nkernel;
  const int elems = rb << ltl;
  float* tr = smem;
  float* ti = tr + elems;
  float* g = ti + elems;
  load_gates(g, gr, gi, nkernel);
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const long off = tile_off(e, ltl, rb);
    tr[e] = xr[off];
    ti[e] = xi[off];
  }
  __syncthreads();
  const int half = elems >> 1;
  for (int st = 0; st < nkernel; ++st) {
    const int q = WALK ? nkernel - 1 - st : st;
    const int ls = nkernel - 1 - q;  // log2 of the row stride
    const float* m = g + 8 * q;
    // a = g, or g^T for the walk: lo' = a00 lo + a01 hi, hi' = a10 lo + a11 hi
    const float a00r = m[0], a00i = m[1], a11r = m[6], a11i = m[7];
    const float a01r = WALK ? m[4] : m[2], a01i = WALK ? m[5] : m[3];
    const float a10r = WALK ? m[2] : m[4], a10i = WALK ? m[3] : m[5];
    for (int p = threadIdx.x; p < half; p += blockDim.x) {
      int elo, ehi;
      pair_elems(p, ls, ltl, &elo, &ehi);
      const float ar = tr[elo], ai = ti[elo], br = tr[ehi], bi = ti[ehi];
      tr[elo] = a00r * ar - a00i * ai + a01r * br - a01i * bi;
      ti[elo] = a00r * ai + a00i * ar + a01r * bi + a01i * br;
      tr[ehi] = a10r * ar - a10i * ai + a11r * br - a11i * bi;
      ti[ehi] = a10r * ai + a10i * ar + a11r * bi + a11i * br;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const long off = tile_off(e, ltl, rb);
    yr[off] = tr[e];
    yi[off] = ti[e];
  }
}

// K11's row pass: rx(th_q) for q = 0..nkernel-1 on its bit.  x and y may
// alias.
__global__ void __launch_bounds__(THREADS)
rotx_fwd_kernel(const float* xr, const float* xi, float* yr, float* yi,
                const float* __restrict__ th, int nkernel, int ltl) {
  extern __shared__ float smem[];
  const int rb = 1 << nkernel;
  const int elems = rb << ltl;
  float* tr = smem;
  float* ti = tr + elems;
  float* cs = ti + elems;  // (cos, sin) of the half angles
  for (int q = threadIdx.x; q < nkernel; q += blockDim.x)
    sincosf(0.5f * th[q], &cs[2 * q + 1], &cs[2 * q]);
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const long off = tile_off(e, ltl, rb);
    tr[e] = xr[off];
    ti[e] = xi[off];
  }
  __syncthreads();
  const int half = elems >> 1;
  for (int q = 0; q < nkernel; ++q) {
    const int ls = nkernel - 1 - q;
    const float c = cs[2 * q], sn = cs[2 * q + 1];
    for (int p = threadIdx.x; p < half; p += blockDim.x) {
      int elo, ehi;
      pair_elems(p, ls, ltl, &elo, &ehi);
      const float ar = tr[elo], ai = ti[elo], br = tr[ehi], bi = ti[ehi];
      tr[elo] = c * ar + sn * bi;
      ti[elo] = c * ai - sn * br;
      tr[ehi] = c * br + sn * ai;
      ti[ehi] = c * bi - sn * ar;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const long off = tile_off(e, ltl, rb);
    yr[off] = tr[e];
    yi[off] = ti[e];
  }
}

template <bool WALK>
cudaError_t row_apply(const RowPlan& p, const float* xr, const float* xi,
                      float* yr, float* yi, const float* gr, const float* gi,
                      int nkernel, cudaStream_t s) {
  const size_t smem = row_smem(2, nkernel, 0);
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(row_apply_kernel<WALK>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  row_apply_kernel<WALK><<<p.grid, THREADS, smem, s>>>(xr, xi, yr, yi, gr, gi,
                                                       nkernel, p.ltl);
  return cudaGetLastError();
}

// K7's and K12's stage plan on (r, 128) planes, r = 2^nrb: the row stage
// walks the nkernel low row bits; false for a shape it does not take.
bool bwd_plan(int r, int nkernel, RowStage* rs) {
  const int nrb = ilog2(r);
  if (nkernel < 1 || nkernel > MAX_NKERNEL || r < 2 || r != 1 << nrb || nkernel > nrb) return false;
  return row_stage_plan(nrb, LANE_BITS, nkernel, rs);
}

struct BwdScratch {
  float *part_row, *part_dm, *pr, *pi;
};

// Floats of K7's scratch; fills s when base is given.  psi's planes hold
// the lane stage's output or the first of two passes'; the cotangent goes
// through ds.
size_t bwd_layout(int r, const RowStage& rs, bool lane, float* base, BwdScratch* s) {
  const size_t plane = static_cast<size_t>(r) * LANES;
  const bool psi = lane || rs.npass == 2;
  const size_t sizes[4] = {
      gate_part_floats(rs),
      lane ? dm_floats(dm_chunks(r, LANE_BITS), LANE_BITS) : 0,
      psi ? plane : 0, psi ? plane : 0,
  };
  float* ptrs[4];
  size_t off = 0;
  for (int i = 0; i < 4; ++i) {
    ptrs[i] = base ? base + off : nullptr;
    off += (sizes[i] + 63) / 64 * 64;  // 16-byte aligned parts
  }
  if (s) *s = BwdScratch{ptrs[0], ptrs[1], ptrs[2], ptrs[3]};
  return off;
}

// K12's scratch: the row stage's partials and, with two passes, psi's
// planes (the cotangent goes through ds); fills s when base is given.
size_t rotx_layout(int r, const RowStage& rs, float* base, BwdScratch* s) {
  const size_t plane = rs.npass == 2 ? static_cast<size_t>(r) * LANES : 0;
  const size_t part = (row_part_floats(rs, 0) + 63) / 64 * 64;
  if (s) *s = BwdScratch{base, nullptr, base ? base + part : nullptr, base ? base + part + plane : nullptr};
  return part + 2 * plane;
}

}  // namespace

extern "C" {

const char* tcng_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K6.  sr/si, yr/yi: (r, 128) planes (may alias); gr/gi (nkernel, 4) gate
// planes; mr/mi (128, 128) lane planes or null.  Returns the first CUDA
// error (cudaErrorInvalidValue for a shape it does not take), 0 on success.
int tcng_row_fwd(const float* sr, const float* si, float* yr, float* yi,
                 const float* gr, const float* gi, int nkernel,
                 const float* mr, const float* mi, int r, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RowPlan p;
  if (!row_plan(r, nkernel, &p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = row_apply<false>(p, sr, si, yr, yi, gr, gi, nkernel, s);
  if (err != cudaSuccess || mr == nullptr) return static_cast<int>(err);
  return static_cast<int>(lane_fwd_stage(yr, yi, yr, yi, mr, mi, r, s));
}

// Floats of scratch tcng_row_bwd needs for these shapes (-1: a shape it
// does not take).
long tcng_row_bwd_scratch(int r, int nkernel, int lane) {
  RowStage rs;
  if (!bwd_plan(r, nkernel, &rs)) return -1;
  return static_cast<long>(bwd_layout(r, rs, lane != 0, nullptr, nullptr));
}

// K7's stage kernels' plan at these shapes, for the record: four records
// of 8 (kernel_record): the lane pair and dM (0 CTAs without the lane; x1,
// x2 = the tile's rows and columns, dM's chunks and rows a chunk), the
// row stage's first pass and its last (x1 = tile elements, x2 = the pass's
// row bits; the first has 0 CTAs when there is one pass).
int tcng_row_bwd_plan(int r, int nkernel, int lane, long* out) {
  RowStage rs;
  if (!bwd_plan(r, nkernel, &rs)) return static_cast<int>(cudaErrorInvalidValue);
  const int nc = dm_chunks(r, LANE_BITS);
  cudaError_t err = kernel_record(reinterpret_cast<const void*>(wide_nt_kernel<2, true>),
                                  lane ? prod_ctas(r, LANE_BITS) : 0, THREADS, prod_smem<2>(), P_T,
                                  P_T, out);
  if (err == cudaSuccess)
    err = kernel_record(reinterpret_cast<const void*>(wide_dm_kernel), lane ? 4L * nc : 0, THREADS,
                        DM_SMEM, nc, r / nc, out + 8);
  for (int k = 0; k < 2 && err == cudaSuccess; ++k) {
    const bool last = k == 1;
    const RowPass& rp = last ? last_pass(rs) : rs.pass[0];
    const bool runs = last || rs.npass == 2;
    err = kernel_record(gate_pass_fn(last), runs ? row_ctas(rs) : 0, row_threads(rs),
                        gate_stage_smem(rs), 1L << rp.tb, runs ? rp.nb : 0, out + 16 + 8 * k);
  }
  return static_cast<int>(err);
}

// K7.  yr/yi: the layer's (r, 128) output planes (post-lane when mr is
// given), r = 2^nrb >= 2^nkernel; ctr/cti: cotangent planes; dsr/dsi: (r,
// 128) output, aliasing no input; dg: (2, nkernel, 4) = (re, im) of the
// gate cotangent; dm: (2, 128, 128) = (dmr, dmi) or null without the lane;
// gr/gi (nkernel, 4); mr/mi (128, 128) unitary lane planes or null;
// scratch of tcng_row_bwd_scratch floats.  y and ct are not written.
int tcng_row_bwd(const float* yr, const float* yi, const float* ctr,
                 const float* cti, float* dsr, float* dsi, float* dg,
                 float* dm, const float* gr, const float* gi, int nkernel,
                 const float* mr, const float* mi, float* scratch, int r,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RowStage rs;
  if (!bwd_plan(r, nkernel, &rs)) return static_cast<int>(cudaErrorInvalidValue);
  BwdScratch s;
  bwd_layout(r, rs, mr != nullptr, scratch, &s);
  const float *psr = yr, *psi = yi, *cr = ctr, *ci = cti;
  cudaError_t err = gate_stage_prepare(rs);
  if (err == cudaSuccess && mr != nullptr) {
    // the adjoint's lane stage (adjoint_stages.cuh), as K3's: psi into
    // scratch, the walked cotangent into ds
    if (!all_aligned16({yr, yi, ctr, cti, dsr, dsi, mr, mi, scratch}))
      return static_cast<int>(cudaErrorMisalignedAddress);
    err = lane_stage_prepare();
    if (err == cudaSuccess)
      err = adjoint_lane_stage(r, LANE_BITS, yr, yi, ctr, cti, mr, mi, s.pr, s.pi, dsr, dsi,
                               s.part_dm, dm, MM, dm_chunks(r, LANE_BITS), st);
    psr = s.pr, psi = s.pi, cr = dsr, ci = dsi;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      gate_row_stage(rs, psr, psi, cr, ci, s.pr, s.pi, dsr, dsi, s.part_row, gr, gi, dg, st));
}

// K8.  ctr/cti, dsr/dsi: (r, 128) planes (may alias); gr/gi (nkernel, 4).
int tcng_row_bwd_const(const float* ctr, const float* cti, float* dsr,
                       float* dsi, const float* gr, const float* gi,
                       int nkernel, int r, void* stream) {
  RowPlan p;
  if (!row_plan(r, nkernel, &p)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(row_apply<true>(p, ctr, cti, dsr, dsi, gr, gi, nkernel,
                                          static_cast<cudaStream_t>(stream)));
}

// K11.  sr/si, yr/yi: (r, 128) planes (may alias); th (nkernel) angles.
int tcng_rotx_fwd(const float* sr, const float* si, float* yr, float* yi,
                  const float* th, int nkernel, int r, void* stream) {
  RowPlan p;
  if (!row_plan(r, nkernel, &p)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = row_smem(2, 0, 2 * nkernel);
  cudaError_t err = cudaFuncSetAttribute(
      rotx_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rotx_fwd_kernel<<<p.grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      sr, si, yr, yi, th, nkernel, p.ltl);
  return static_cast<int>(cudaGetLastError());
}

// Floats of scratch tcng_rotx_bwd needs (-1: a shape it does not take).
long tcng_rotx_bwd_scratch(int r, int nkernel) {
  RowStage rs;
  if (!bwd_plan(r, nkernel, &rs)) return -1;
  return static_cast<long>(rotx_layout(r, rs, nullptr, nullptr));
}

// K12's row passes' plan at these shapes, for the record: two records of 8
// (kernel_record): the first pass and the last (x1 = tile elements, x2 =
// the pass's row bits; the first has 0 CTAs when there is one pass).
int tcng_rotx_bwd_plan(int r, int nkernel, long* out) {
  RowStage rs;
  if (!bwd_plan(r, nkernel, &rs)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  for (int k = 0; k < 2 && err == cudaSuccess; ++k) {
    const bool last = k == 1;
    const RowPass& rp = last ? last_pass(rs) : rs.pass[0];
    const bool runs = last || rs.npass == 2;
    const void* fn = last ? reinterpret_cast<const void*>(rx_row_pass_kernel) : row_pass_fn(false);
    err = kernel_record(fn, runs ? row_ctas(rs) : 0, row_threads(rs), row_pass_smem(rp, 0, last),
                        1L << rp.tb, runs ? rp.nb : 0, out + 8 * k);
  }
  return static_cast<int>(err);
}

// K12.  yr/yi: the layer's (r, 128) output planes, r = 2^nrb >= 2^nkernel;
// ctr/cti: cotangent planes; dsr/dsi (r, 128) output, aliasing no input;
// dth (nkernel) output; th (nkernel); scratch of tcng_rotx_bwd_scratch
// floats.  y and ct are not written.
int tcng_rotx_bwd(const float* yr, const float* yi, const float* ctr,
                  const float* cti, float* dsr, float* dsi, float* dth,
                  const float* th, int nkernel, float* scratch, int r,
                  void* stream) {
  RowStage rs;
  if (!bwd_plan(r, nkernel, &rs)) return static_cast<int>(cudaErrorInvalidValue);
  BwdScratch s;
  rotx_layout(r, rs, scratch, &s);
  return static_cast<int>(rx_row_stage(rs, yr, yi, ctr, cti, s.pr, s.pi, dsr, dsi, s.part_row, th,
                                       dth, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
