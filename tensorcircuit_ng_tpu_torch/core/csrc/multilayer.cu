// Whole-block multi-layer zzrx kernels for Hopper (sm_90a): L layers of
// [zz phase over all n qubits; rx on every row bit; lane matmul] and their
// adjoint, on the (2^nrow, W) float32 plane pair of a complex64
// statevector, nrow <= 12 row qubits and W = 2^lw lanes, 128 <= W <= 1024.
// Layout index = row * W + lane; qubit q is bit n-1-q of the flat index;
// rx angle q acts on the row bit of stride 2^(nrow-1-q).
//
// Conventions (those of the JAX package): cotangent planes are
// (dL/dyr, -dL/dyi), the non-conjugating complex cotangent, and walk by the
// TRANSPOSE of each map; the lane-matrix cotangent planes are
// (dL/dmr, -dL/dmi).  The lane matrices M_l are unitary right-multiplication
// matrices, so the backward rebuilds every state by un-application.
//
// K9 tcng_ml_fwd replaces kernels_multilayer._pallas_ml_fwd
//    (_ml_fwd_kernel): per layer the phase exp(-i/2 sum_k th_k z_a z_b), the
//    nrow rx butterflies, then y = x @ M_l.
// K10 tcng_ml_bwd replaces kernels_multilayer._pallas_ml_bwd
//    (_ml_bwd_kernel): the layers in reverse; per layer
//      psi = y @ conj(M)^T;  dM_l = psi^T ct;  ct <- ct @ M^T        (lane)
//      per row bit: un-apply rx from psi, dth_q from the two sums
//      -1/2 s Re S1 + 1/2 c Im S2, walk ct by rx^T = rx                (rx)
//      dzz_k = 1/2 sum h z_a z_b, h = ct_r z_i + ct_i z_r; ct <- ct * phase;
//      x = conj(phase) * z                                            (zz)
//    and returns ds = ct, (dzz, dth) a layer and dM.  The rx gates of a
//    layer act on distinct bits and commute, so K9 and K10 take the row
//    bits in another order than the JAX kernels (the sums differ by
//    rounding).
//
// Design.  The TPU keeps the whole state (8 MB of planes at n = 20) resident
// in VMEM across the L grid steps; a CTA holds at most 227 KB.  So one C
// entry point launches stage kernels layer by layer on the caller's stream,
// and a layer's planes (32 MB at n = 20: y, ct, psi, w) stay in the 50 MB L2.
// Bound at n = 20, L = 4: operations.  Each lane product is 8 W flops an
// amplitude, 2.15 GFLOP a layer at W = 256 (32.05 us at 67 TFLOP/s float32
// outside the tensor cores; three a layer backward); the backward's row
// stage moves 33.5 MB a layer (10 us at 3.35 TB/s), the forward's 16.8 MB
// (5 us).  Plain f32 FMAs, no fast-math.
//
// Both run on the stages of adjoint_stages.cuh, which K3, K4 and K7 share,
// on one row-stage plan, row_stage_plan(nrow, lw, nrow): tiles of 2^11
// elements with 32 consecutive lanes a warp (whole 32-byte sectors), the
// row bits in at most two passes of at most 6 (at nrow = 12, W = 256: two
// of 6, 512 CTAs), a thread holding 8 elements in registers for 3 bits at
// a time, the zz exponent E0 + sum_u A_u s_u + sum_uv B_uv s_u s_v over
// its 3 register bits from the pair records that ml_pair_records_kernel
// sorts once a call for the pass over the low row bits (one record set for
// every layer; the pass joins each record with the layer's angle), the
// phase through sincospif.  K10: the lane pair and split-K dM
// (adjoint_lane_stage), then the row stage (adjoint_row_stage) walking the
// high row bits and then the low ones with the zz stage, x = conj(phase) z
// kept for the next layer.  K9: the forward row stage (fwd_row_stage): the
// phase and the low row bits' rx in one pass over the tiles of K10's last
// pass, the high row bits' rx in the other, in place; then the product
// wide_nt_kernel<1, false> on M^T, transposed once a call
// (transpose_kernel, adjoint_stages.cuh).
//   Scratch at n = 20: K9 the row stage's output (8 MB) and M^T; K10 y, psi
//   and w (24 MB), the dM partials (8 MB).
// The TPU's "interleave sweep", the host-built sign matrices and the
// 128-column pair padding are layout devices of the TPU and are not carried
// over.

#include "adjoint_stages.cuh"

namespace {

constexpr int ML_MAX_NROW = 12;
constexpr int ML_MAX_PAIRS = 128;

// ---------------------------------------------------------------------------
// Plans and entry points.
// ---------------------------------------------------------------------------

struct MlPlan {
  int r, lw;
  RowStage rs;  // the row stage of K9 and K10: every row bit walked
};

// false for a shape the kernels do not take.
bool ml_plan(int r, int lanes, int nrow, int npairs, MlPlan* p) {
  if (nrow < 1 || nrow > ML_MAX_NROW || r != (1 << nrow)) return false;
  const int lw = ilog2(lanes);
  if ((1 << lw) != lanes || lw < 7 || lw > 10) return false;
  if (npairs < 0 || npairs > ML_MAX_PAIRS) return false;
  p->r = r;
  p->lw = lw;
  return row_stage_plan(nrow, lw, nrow, &p->rs);
}

struct MlScratch {
  float *tr, *ti, *mtr, *mti;                        // K9
  float *yr, *yi, *pr, *pi, *wr, *wi, *part_row, *part_dm;  // K10
  float* rec;                                        // both
};

// Floats of scratch (bwd = 0: K9, 1: K10), each part a multiple of 64
// floats (16-byte aligned); fills s when base is given.
size_t ml_layout(const MlPlan& p, int npairs, int L, bool bwd, float* base, MlScratch* s) {
  const size_t plane = static_cast<size_t>(p.r) << p.lw;
  const size_t mats = static_cast<size_t>(L) << (2 * p.lw);
  size_t sizes[13] = {
      bwd ? 0 : plane, bwd ? 0 : plane, bwd ? 0 : mats, bwd ? 0 : mats,
      bwd ? plane : 0, bwd ? plane : 0, bwd ? plane : 0, bwd ? plane : 0,
      bwd ? plane : 0, bwd ? plane : 0,
      bwd ? row_part_floats(p.rs, npairs) : 0,
      bwd ? dm_floats(dm_chunks(p.r, p.lw), p.lw) : 0,
      pair_record_floats(npairs),
  };
  float* ptrs[13];
  const size_t off = carve(sizes, base, ptrs);
  if (s)
    *s = MlScratch{ptrs[0], ptrs[1], ptrs[2], ptrs[3], ptrs[4], ptrs[5],
                   ptrs[6], ptrs[7], ptrs[8], ptrs[9], ptrs[10], ptrs[11], ptrs[12]};
  return off;
}

}  // namespace

extern "C" {

const char* tcng_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of scratch tcng_ml_fwd (bwd = 0) or tcng_ml_bwd (bwd = 1) needs for
// these shapes; -1 for a shape the kernels do not take.
long tcng_ml_scratch(int r, int lanes, int nrow, int npairs, int L, int bwd) {
  MlPlan p;
  if (L < 1 || !ml_plan(r, lanes, nrow, npairs, &p)) return -1;
  return static_cast<long>(ml_layout(p, npairs, L, bwd != 0, nullptr, nullptr));
}

// The stage kernels' plan at these shapes, for the record: seven records
// of 8 (kernel_record): K10's product pair (x1, x2 = the tile's rows and
// columns), K9's product (the same), K10's dM (x1 = chunks, x2 = rows a
// chunk), K10's first row pass and its last, K9's zz pass (the last
// pass's tiles, first in the forward) and its other pass (x1 = tile
// elements, x2 = the pass's row bits; a pass that does not run, with one
// pass, has 0 CTAs).
int tcng_ml_plan(int r, int lanes, int nrow, int npairs, long* out) {
  MlPlan p;
  if (!ml_plan(r, lanes, nrow, npairs, &p)) return static_cast<int>(cudaErrorInvalidValue);
  const long prod = prod_ctas(r, p.lw);
  const int nc = dm_chunks(r, p.lw);
  cudaError_t err = kernel_record(reinterpret_cast<const void*>(wide_nt_kernel<2, true>), prod,
                                  THREADS, prod_smem<2>(), P_T, P_T, out);
  if (err == cudaSuccess)
    err = kernel_record(reinterpret_cast<const void*>(wide_nt_kernel<1, false>), prod, THREADS,
                        prod_smem<1>(), P_T, P_T, out + 8);
  if (err == cudaSuccess)
    err = kernel_record(reinterpret_cast<const void*>(wide_dm_kernel), static_cast<long>(nc) << (2 * (p.lw - 6)),
                        THREADS, DM_SMEM, nc, r / nc, out + 16);
  // K10's first and last pass, then K9's zz pass (the last pass's tiles)
  // and its other
  for (int k = 0; k < 4 && err == cudaSuccess; ++k) {
    const bool fwd = k >= 2, last = fwd ? k == 2 : k == 1;
    const RowPass& rp = last ? last_pass(p.rs) : p.rs.pass[0];
    const bool runs = last || p.rs.npass == 2;
    err = kernel_record(fwd ? fwd_pass_fn(last) : row_pass_fn(last), runs ? row_ctas(p.rs) : 0,
                        row_threads(p.rs), fwd ? fwd_pass_smem(rp, npairs, last) : row_pass_smem(rp, npairs, last),
                        1L << rp.tb, runs ? rp.nb : 0, out + 24 + 8 * k);
  }
  return static_cast<int>(err);
}

// K9.  sr/si (r, W) input planes, r = 2^nrow; yr/yi (r, W) output; zzth
// (L, npairs); shifts (npairs, 2) = (n-1-a, n-1-b); th (L, nrow); mr/mi
// (L, W, W) lane planes; scratch of tcng_ml_scratch(.., 0) floats; every
// plane 16-byte aligned.  Returns the first CUDA error
// (cudaErrorInvalidValue for a shape it does not take), 0 on success.
int tcng_ml_fwd(const float* sr, const float* si, float* yr, float* yi,
                const float* zzth, const int* shifts, int npairs,
                const float* th, int nrow, int L, const float* mr,
                const float* mi, float* scratch, int r, int lanes,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MlPlan p;
  if (L < 1 || !ml_plan(r, lanes, nrow, npairs, &p)) return static_cast<int>(cudaErrorInvalidValue);
  if (!all_aligned16({sr, si, yr, yi, mr, mi, scratch})) return static_cast<int>(cudaErrorMisalignedAddress);
  MlScratch s;
  ml_layout(p, npairs, L, false, scratch, &s);
  cudaError_t err = fwd_stage_prepare(p.rs, npairs);
  if (err == cudaSuccess)
    err = set_smem(reinterpret_cast<const void*>(wide_nt_kernel<1, false>), prod_smem<1>());
  // the zz pass's pair records, once a call for every layer
  if (err == cudaSuccess) err = pair_records(p.rs, shifts, npairs, s.rec, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // M^T once a call: the product reads its b operand as b[n][k]
  err = transpose_planes(mr, mi, s.mtr, s.mti, L, p.lw, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t ww = static_cast<size_t>(lanes) * lanes;
  for (int l = 0; l < L; ++l) {
    err = fwd_row_stage(p.rs, l == 0 ? sr : yr, l == 0 ? si : yi, s.tr, s.ti, s.rec,
                        zzth + l * npairs, npairs, th + l * nrow, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = wide_nt<1, false>(s.tr, s.ti, nullptr, nullptr, s.mtr + l * ww, s.mti + l * ww, yr, yi,
                            nullptr, nullptr, r, p.lw, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// K10.  yr/yi: K9's (r, W) output planes; ctr/cti: cotangent planes;
// dsr/dsi (r, W) output; grads (L, npairs + nrow) = (dzz, dth) a layer; dm
// (2, L, W, W) = (dmr, dmi); zzth, shifts, th, mr/mi as K9's (mr/mi
// unitary); scratch of tcng_ml_scratch(.., 1) floats; every plane 16-byte
// aligned.
int tcng_ml_bwd(const float* yr, const float* yi, const float* ctr,
                const float* cti, float* dsr, float* dsi, float* grads,
                float* dm, const float* zzth, const int* shifts, int npairs,
                const float* th, int nrow, int L, const float* mr,
                const float* mi, float* scratch, int r, int lanes,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MlPlan p;
  if (L < 1 || !ml_plan(r, lanes, nrow, npairs, &p)) return static_cast<int>(cudaErrorInvalidValue);
  if (!all_aligned16({yr, yi, ctr, cti, dsr, dsi, dm, mr, mi, scratch}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  MlScratch s;
  ml_layout(p, npairs, L, true, scratch, &s);
  cudaError_t err = lane_stage_prepare();
  if (err == cudaSuccess) err = row_stage_prepare(p.rs, npairs);
  // every layer's pair records for the zz stage, once a call
  if (err == cudaSuccess) err = pair_records(p.rs, shifts, npairs, s.rec, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t ww = static_cast<size_t>(lanes) * lanes;
  const int w = npairs + nrow, nc = dm_chunks(r, p.lw);
  for (int l = L - 1; l >= 0; --l) {
    const float* ysr = l == L - 1 ? yr : s.yr;
    const float* ysi = l == L - 1 ? yi : s.yi;
    const float* cr = l == L - 1 ? ctr : dsr;
    const float* ci = l == L - 1 ? cti : dsi;
    // psi = y @ conj(M)^T -> (pr, pi) and ct @ M^T -> (wr, wi); dM = psi^T ct
    err = adjoint_lane_stage(r, p.lw, ysr, ysi, cr, ci, mr + l * ww, mi + l * ww, s.pr, s.pi, s.wr,
                             s.wi, s.part_dm, dm + l * ww, static_cast<long>(L * ww), nc, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    // the row stage in place (x into y's scratch for the next layer, none
    // after layer 0)
    err = adjoint_row_stage(p.rs, s.pr, s.pi, s.wr, s.wi, s.pr, s.pi, s.wr, s.wi, l ? s.yr : nullptr,
                            l ? s.yi : nullptr, dsr, dsi, s.part_row, s.rec, zzth + l * npairs, npairs,
                            th + l * nrow, grads + l * w, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
