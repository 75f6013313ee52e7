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
//    (_const_bwd_kernel): the ct walk by g^T alone, gate q = nkernel-1..0.
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
// (nkernel = 11), nine times a CTA's 227 KB of shared memory, and a tile
// of all RB rows by 8 lanes (whole 32-byte sectors) would give only 64
// CTAs at n = 20.  So every kernel here runs on the row stage of
// adjoint_stages.cuh (the plan row_stage_plan(nrb, 7, nkernel) that K3, K4
// and K10 use): tiles of 2^11 elements with 32 consecutive lanes a warp
// (whole sectors), the walked bits in at most two passes of at most 6 (at
// n = 20, nkernel = 11: the 6 low ones and the 5 high ones; 512 CTAs of
// 256 threads, 4 an SM), a thread holding 8 elements in registers for 3
// bits at a time and crossing shared memory once for more.  K6, K8 and K11
// (bfly_row_stage): K9's forward passes without the phase, the low bits
// on the last pass's tiles first, then the high ones in place; K11 with
// rx, K6 with a general gate a walked bit (the pass's gates staged in
// shared memory, 8 floats a bit), K8 with the same gates staged transposed
// (the walk ct <- g^T ct: only the staging load differs from K6's).  With
// the lane (the fuse_lane route) K6 runs the row stage into a scratch
// plane pair, then y = x @ M by the forward product of K2 and K9
// (wide_nt_kernel<1, false> on M^T, transposed once a call).  K7
// (gate_row_stage), per bit: un-apply g^dagger, the eight dg sums reduced
// over the warp at once by halving exchanges (warp_sum8), the ct walk by
// g^T.  K12 (rx_row_stage): K10's rx butterflies without the zz stage, the
// first pass ml_row_pass_kernel<false> with no pairs, the last
// rx_row_pass_kernel (no pair records, phase or x planes); the two dth
// sums a bit go through a warp tree into one partial a CTA.  The gates act
// on distinct bits and commute, so K6, K7, K8, K11 and K12 take them in
// another order than the JAX kernels (only rounding differs).  K7, K8 and
// K12 run on the caller's ct, which they do not write (K7 and K12 also on
// y): the first of two passes writes ds (K7 and K12 also psi to scratch),
// the last only ds.  With the lane K7 first runs the adjoint lane stage
// that K3, K4 and K10 share (the un-lane and ct walk in one launch, dM as
// split-K partials), psi into scratch and ct into ds, and the passes
// follow in place.  The dg and dth sums are one partial a CTA added by
// colsum_tree_kernel in a fixed order: no atomics, so K7 and K12 are
// bit-identical run to run.
// Bounds at n = 20, nkernel = 11, on the H100 (3.35 TB/s, 67 TFLOP/s
// float32): K6 and K8 without the lane move 16.8 MB (two planes in, two
// out) for 0.16 GFLOP, 0.005 ms, bound by bytes; K6 with the lane the 1.07
// GFLOP lane product and the butterflies bound it by operations (0.018
// ms); K7 without the lane moves 25 MB for 0.5 GFLOP (0.0076 ms,
// operations).
// At n = 20, nkernel = 10 (r = 8192), K11 moves 16.8 MB (0.005 ms, bytes)
// and K12 25 MB for 20 flops an amplitude a bit (0.0075 ms, bytes).
// Plain f32 FMAs, no fast-math.

#include "adjoint_stages.cuh"

namespace {

// the row stage walks at most 11 row bits (the JAX package's
// MAX_KERNEL_QUBITS)
constexpr int MAX_NKERNEL = 11;
// log2 of the lanes
constexpr int LANE_BITS = 7;

// The row stage's plan of K6, K7, K8, K11 and K12 on (r, 128) planes, r =
// 2^nrb: it walks the nkernel low row bits; false for a shape it does not
// take.
bool stage_plan(int r, int nkernel, RowStage* rs) {
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
  const size_t off = carve(sizes, base, ptrs);
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

struct FwdScratch {
  float *mtr, *mti, *tr, *ti;
};

// Floats of K6's scratch, each part a multiple of 64 floats (16-byte
// aligned): with the lane M^T's two planes and the row stage's output
// planes, without it none; fills s when base is given.
size_t fwd_layout(int r, bool lane, float* base, FwdScratch* s) {
  const size_t plane = lane ? static_cast<size_t>(r) * LANES : 0, mm = lane ? MM : 0;
  const size_t sizes[4] = {mm, mm, plane, plane};
  float* ptrs[4];
  const size_t off = carve(sizes, base, ptrs);
  if (s) *s = FwdScratch{ptrs[0], ptrs[1], ptrs[2], ptrs[3]};
  return off;
}

// The forward passes' records (kernel_record) of K6 (GATE), K8 (GATE and
// TRANS) or K11 into out[0..16): the first pass (pass[0]) and the last,
// x1 = tile elements, x2 = the pass's row bits; with one pass the first
// has 0 CTAs.
template <bool GATE, bool TRANS>
cudaError_t bfly_pass_records(const RowStage& rs, long* out) {
  cudaError_t err = cudaSuccess;
  for (int k = 0; k < 2 && err == cudaSuccess; ++k) {
    const bool last = k == 1;
    const RowPass& rp = last ? last_pass(rs) : rs.pass[0];
    const bool runs = last || rs.npass == 2;
    err = kernel_record(reinterpret_cast<const void*>(fwd_row_pass_kernel<false, GATE, TRANS>),
                        runs ? row_ctas(rs) : 0, row_threads(rs), fwd_pass_smem(rp, 0, false, GATE),
                        1L << rp.tb, runs ? rp.nb : 0, out + 8 * k);
  }
  return err;
}

}  // namespace

extern "C" {

const char* tcng_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of scratch tcng_row_fwd needs for these shapes (-1: a shape it
// does not take).
long tcng_row_fwd_scratch(int r, int nkernel, int lane) {
  RowStage rs;
  if (!stage_plan(r, nkernel, &rs)) return -1;
  return static_cast<long>(fwd_layout(r, lane != 0, nullptr, nullptr));
}

// K6's stage kernels' plan at these shapes, for the record: three records
// of 8 (kernel_record): the lane product (0 CTAs without the lane; x1, x2
// = the tile's rows and columns), the row stage's first pass and its last
// (x1 = tile elements, x2 = the pass's row bits; the first has 0 CTAs when
// there is one pass).  The last pass's bits run first.
int tcng_row_fwd_plan(int r, int nkernel, int lane, long* out) {
  RowStage rs;
  if (!stage_plan(r, nkernel, &rs)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = kernel_record(reinterpret_cast<const void*>(wide_nt_kernel<1, false>),
                                  lane ? prod_ctas(r, LANE_BITS) : 0, THREADS, prod_smem<1>(), P_T,
                                  P_T, out);
  if (err == cudaSuccess) err = bfly_pass_records<true, false>(rs, out + 8);
  return static_cast<int>(err);
}

// K6.  sr/si, yr/yi: (r, 128) planes, r = 2^nrb >= 2^nkernel (may alias
// without the lane); gr/gi (nkernel, 4) gate planes; mr/mi (128, 128) lane
// planes or null; scratch of tcng_row_fwd_scratch floats (null without the
// lane).  With the lane every pointer is 16-byte aligned and sr/si are not
// written.  Returns the first CUDA error (cudaErrorInvalidValue for a
// shape it does not take), 0 on success.
int tcng_row_fwd(const float* sr, const float* si, float* yr, float* yi,
                 const float* gr, const float* gi, int nkernel,
                 const float* mr, const float* mi, float* scratch, int r,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RowStage rs;
  if (!stage_plan(r, nkernel, &rs)) return static_cast<int>(cudaErrorInvalidValue);
  if (mr == nullptr) return static_cast<int>(bfly_row_stage<true, false>(rs, sr, si, yr, yi, gr, gi, st));
  // the product may not alias its input: the row stage writes scratch
  if (!all_aligned16({sr, si, yr, yi, mr, mi, scratch}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  FwdScratch s;
  fwd_layout(r, true, scratch, &s);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(wide_nt_kernel<1, false>), prod_smem<1>());
  // M^T once a call: the product reads its b operand as b[n][k]
  if (err == cudaSuccess) err = transpose_planes(mr, mi, s.mtr, s.mti, 1, LANE_BITS, st);
  if (err == cudaSuccess) err = bfly_row_stage<true, false>(rs, sr, si, s.tr, s.ti, gr, gi, st);
  if (err == cudaSuccess)
    err = wide_nt<1, false>(s.tr, s.ti, nullptr, nullptr, s.mtr, s.mti, yr, yi, nullptr, nullptr, r,
                            LANE_BITS, st);
  return static_cast<int>(err);
}

// Floats of scratch tcng_row_bwd needs for these shapes (-1: a shape it
// does not take).
long tcng_row_bwd_scratch(int r, int nkernel, int lane) {
  RowStage rs;
  if (!stage_plan(r, nkernel, &rs)) return -1;
  return static_cast<long>(bwd_layout(r, rs, lane != 0, nullptr, nullptr));
}

// K7's stage kernels' plan at these shapes, for the record: four records
// of 8 (kernel_record): the lane pair and dM (0 CTAs without the lane; x1,
// x2 = the tile's rows and columns, dM's chunks and rows a chunk), the
// row stage's first pass and its last (x1 = tile elements, x2 = the pass's
// row bits; the first has 0 CTAs when there is one pass).
int tcng_row_bwd_plan(int r, int nkernel, int lane, long* out) {
  RowStage rs;
  if (!stage_plan(r, nkernel, &rs)) return static_cast<int>(cudaErrorInvalidValue);
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
  if (!stage_plan(r, nkernel, &rs)) return static_cast<int>(cudaErrorInvalidValue);
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

// K8's row passes' plan at these shapes, for the record: two records of 8
// (kernel_record): the first pass and the last (x1 = tile elements, x2 =
// the pass's row bits; the first has 0 CTAs when there is one pass).  The
// last pass's bits run first.
int tcng_row_bwd_const_plan(int r, int nkernel, long* out) {
  RowStage rs;
  if (!stage_plan(r, nkernel, &rs)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(bfly_pass_records<true, true>(rs, out));
}

// K8.  ctr/cti, dsr/dsi: (r, 128) planes, r = 2^nrb >= 2^nkernel (may
// alias); gr/gi (nkernel, 4) gate planes, each walked transposed.  Returns
// the first CUDA error (cudaErrorInvalidValue for a shape it does not
// take), 0 on success.
int tcng_row_bwd_const(const float* ctr, const float* cti, float* dsr,
                       float* dsi, const float* gr, const float* gi,
                       int nkernel, int r, void* stream) {
  RowStage rs;
  if (!stage_plan(r, nkernel, &rs)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      bfly_row_stage<true, true>(rs, ctr, cti, dsr, dsi, gr, gi, static_cast<cudaStream_t>(stream)));
}

// K11's row passes' plan at these shapes, for the record: two records of
// 8 (kernel_record): the first pass and the last (x1 = tile elements, x2 =
// the pass's row bits; the first has 0 CTAs when there is one pass).  The
// last pass's bits run first.
int tcng_rotx_fwd_plan(int r, int nkernel, long* out) {
  RowStage rs;
  if (!stage_plan(r, nkernel, &rs)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(bfly_pass_records<false, false>(rs, out));
}

// K11.  sr/si, yr/yi: (r, 128) planes, r = 2^nrb >= 2^nkernel (may
// alias); th (nkernel) angles.
int tcng_rotx_fwd(const float* sr, const float* si, float* yr, float* yi,
                  const float* th, int nkernel, int r, void* stream) {
  RowStage rs;
  if (!stage_plan(r, nkernel, &rs)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      bfly_row_stage<false, false>(rs, sr, si, yr, yi, th, nullptr, static_cast<cudaStream_t>(stream)));
}

// Floats of scratch tcng_rotx_bwd needs (-1: a shape it does not take).
long tcng_rotx_bwd_scratch(int r, int nkernel) {
  RowStage rs;
  if (!stage_plan(r, nkernel, &rs)) return -1;
  return static_cast<long>(rotx_layout(r, rs, nullptr, nullptr));
}

// K12's row passes' plan at these shapes, for the record: two records of 8
// (kernel_record): the first pass and the last (x1 = tile elements, x2 =
// the pass's row bits; the first has 0 CTAs when there is one pass).
int tcng_rotx_bwd_plan(int r, int nkernel, long* out) {
  RowStage rs;
  if (!stage_plan(r, nkernel, &rs)) return static_cast<int>(cudaErrorInvalidValue);
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
  if (!stage_plan(r, nkernel, &rs)) return static_cast<int>(cudaErrorInvalidValue);
  BwdScratch s;
  rotx_layout(r, rs, scratch, &s);
  return static_cast<int>(rx_row_stage(rs, yr, yi, ctr, cti, s.pr, s.pi, dsr, dsi, s.part_row, th,
                                       dth, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
