// Backward zzrx kernels for Hopper (sm_90a): the adjoint of one TFIM layer
// (K3) and of the whole L-layer stack (K4), on the (r, 128) float32 plane
// pair of a complex64 statevector.  Layout index = row * 128 + lane; qubit
// q is bit n-1-q of the flat index.
//
// Conventions (those of the JAX package): cotangent planes are
// (dL/dyr, -dL/dyi), the non-conjugating complex cotangent, and walk by the
// TRANSPOSE of each map; the lane matrix cotangent planes are
// (dL/dmr, -dL/dmi).  Gates are unitary, so the backward rebuilds every
// intermediate state from the layer's output by un-application.
//
// K3 tcng_zzrx_bwd replaces kernels_rowlayer._pallas_zzrx_bwd
//    (_zzrx_bwd_kernel, _lane_bwd_prologue).  From the layer output y
//    (post-lane when the lane matrix M is given) and the cotangent ct:
//      psi = y @ conj(M)^T;  dM += psi^T ct;  ct <- ct @ M^T      (lane)
//      per kernel row bit, in reverse: un-apply rx from psi, take dth_q,
//      walk ct through rx^T                                         (rx)
//      dzz_k = 1/2 sum h (1 - 2 xor_k), h = ct_r z_i + ct_i z_r;
//      ct <- ct * phase                                             (zz)
//    and returns ds = ct, dzz (npairs), dth (nkernel) and dM.  With the
//    unitary (R, R) row-kron planes M7 (the FUSE_ROWM branch,
//    kernels_rowlayer._rowm_bwd_stage) stage K14 (rowm.cuh) runs between
//    the lane and the row stages:
//      x = M7^dagger psi and ct' = M7^T ct a block (one pass);
//      dM7 = sum ct x^T over all blocks (partials, colsum);
//    and the row stage walks only the low nkernel - rmx bits (dth of
//    those).
// K4 tcng_grand_zzrx_bwd replaces kernels_grand.grand_zzrx_bwd
//    (_grand_bwd_kernel): the L layers in reverse; each is the outer
//    transpose walk w = mo^T ct across the D = 2^nouter row blocks with
//    dth_outer[q] = 1/2 sum_m sum (w_r[m] k_i[m^dq] + w_i[m] k_r[m^dq])
//    against the residual k = ks[l] (valid because mo is an rx kron), then
//    K3's adjoint with the lane matrix on w.
//
// Design.  As in the forward (zzrx_fwd.cu), a TPU block of 2^10 rows x 128
// lanes does not fit a CTA, so a layer runs as passes over the state, which
// at n = 20 (4 planes of 4 MB between passes) stay in the 50 MB L2.  The
// lane and row stages are the adjoint stages of adjoint_stages.cuh, which
// K10 (multilayer.cu) and K7's lane stage share:
//   lane stage (adjoint_lane_stage, W = 128): the un-lane psi = y @
//     conj(M)^T and the ct walk ct @ M^T in one register-blocked launch
//     (wide_nt_kernel<2, true>: 64 x 64 tiles, 4 x 4 outputs a thread, M's
//     chunks shared), then dM = psi^T ct as split-K partials over row
//     chunks (wide_dm_kernel, dm_chunks: 64 chunks x 4 tiles at n = 20)
//     added by colsum_kernel;
//   row stage (adjoint_row_stage): the walked bits are the low nkernel
//     (nkernel - rmx under the row kron) row bits of each block, in one or
//     two coalesced passes of at most 6 bits with the zz stage in the last
//     (ml_row_pass_kernel), the pairs sorted once a call into records
//     (ml_pair_records_kernel) that take each layer's angles in the pass;
//     the first of two passes runs in place on scratch, or from the
//     caller's planes into scratch (they stay untouched);
//   outer pass (outer_bwd_kernel<D>, K4 only): one thread per in-block
//     position holds its D elements in registers; its dth_outer partials
//     are added by colsum_tree_kernel.
// The outer walk stays ahead of the lane stage: dM = psi^T w needs the
// walked cotangent, though the two maps commute on the state.  Sums over
// the whole state (dM, dzz, dth, dth_outer) are written as one partial per
// CTA (block sums in a fixed shuffle-tree order) and reduced in a fixed
// order: no float atomics, so two runs give the same gradient bit for bit.
// K4 is one C entry point that launches the stage kernels for each layer in
// order on the caller's stream (the outer stage is a grid-wide dependency).
// Bound at n = 20: operations.  The lane stage is three complex 128-deep
// products per amplitude (un-lane, ct walk, dM), 3 * 8 * 128 flops, about
// 3.2 GFLOP a layer against 67 TFLOP/s float32 outside the tensor cores;
// the state moves ~25 MB a layer in the row stage and 24 MB in the outer
// stage.  Plain f32 FMAs, no fast-math.

#include "adjoint_stages.cuh"
#include "rowm.cuh"

namespace {

// outer pass: D <= 16 (nouter <= 4)
constexpr int MAX_NOUTER = 4;
// log2 of the lanes
constexpr int LW = 7;

// K4's outer stage on one in-block position p a thread: w[m] = sum_k
// mo[k][m] ct[k] over the D row blocks (may run in place: a thread reads
// all its D elements before it writes), and the partial dth_outer.
template <int D>
__global__ void __launch_bounds__(THREADS)
outer_bwd_kernel(const float* cr, const float* ci, float* wr, float* wi,
                 const float* ksr, const float* ksi,
                 const float* __restrict__ mor, const float* __restrict__ moi,
                 long be, float* part) {
  constexpr int NO = D == 2 ? 1 : D == 4 ? 2 : D == 8 ? 3 : 4;
  __shared__ float m_r[D * D], m_i[D * D];
  __shared__ float red[NWARPS];
  for (int e = threadIdx.x; e < D * D; e += blockDim.x) {
    m_r[e] = mor[e];
    m_i[e] = moi[e];
  }
  __syncthreads();
  const long p = static_cast<long>(blockIdx.x) * THREADS + threadIdx.x;
  float acc[NO];
#pragma unroll
  for (int q = 0; q < NO; ++q) acc[q] = 0.f;
  if (p < be) {
    float x_r[D], x_i[D], w_r[D], w_i[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      x_r[k] = cr[k * be + p];
      x_i[k] = ci[k * be + p];
    }
#pragma unroll
    for (int m = 0; m < D; ++m) {
      float sr = 0.f, si = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        sr += m_r[k * D + m] * x_r[k] - m_i[k * D + m] * x_i[k];
        si += m_r[k * D + m] * x_i[k] + m_i[k * D + m] * x_r[k];
      }
      w_r[m] = sr;
      w_i[m] = si;
    }
#pragma unroll
    for (int m = 0; m < D; ++m) {
      wr[m * be + p] = w_r[m];
      wi[m * be + p] = w_i[m];
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {  // now the residual k = ks[l]
      x_r[k] = ksr[k * be + p];
      x_i[k] = ksi[k * be + p];
    }
#pragma unroll
    for (int q = 0; q < NO; ++q) {
      const int dq = D >> (q + 1);
#pragma unroll
      for (int m = 0; m < D; ++m)
        acc[q] += w_r[m] * x_i[m ^ dq] + w_i[m] * x_r[m ^ dq];
    }
  }
#pragma unroll
  for (int q = 0; q < NO; ++q) {
    const float s = block_sum(acc[q], red);
    if (threadIdx.x == 0) part[static_cast<long>(blockIdx.x) * NO + q] = 0.5f * s;
  }
}

struct Plan {
  int r;
  RowStage rs;      // the walked row bits
  int nc;           // dM chunks
  int grid_outer;   // K4's outer stage (nwalk = nkernel)
};

// false for a shape the stages do not take.
bool make_plan(int r, int nwalk, Plan* p) {
  const int nrb = ilog2(r);
  if (r < 1 || (1 << nrb) != r || !row_stage_plan(nrb, LW, nwalk, &p->rs)) return false;
  p->r = r;
  p->nc = dm_chunks(r, LW);
  p->grid_outer = static_cast<int>(((static_cast<long>(LANES) << nwalk) + THREADS - 1) / THREADS);
  return true;
}

struct Scratch {
  float *part_row, *part_outer, *part_dm, *part_m7, *pr, *pi, *wr, *wi, *vr, *vi, *rec;
};

// mode 0: K3 without lane, 1: K3 with lane, 2: K4; rmx > 0: K3 with the
// row kron (the row stage then walks the low nkernel - rmx bits only).
// Each part a multiple of 64 floats (16-byte aligned).  Returns the floats
// needed; fills s when base is given.
size_t layout(const Plan& p, int npairs, int mode, int rmx, float* base, Scratch* s) {
  const size_t plane = static_cast<size_t>(p.r) * LANES;
  const bool two = p.rs.npass == 2;
  const size_t psi = (mode || rmx || two) ? plane : 0;  // psi, or the first pass's output
  const size_t w = (mode || two) ? plane : 0;           // the walked ct
  const size_t rowm = rmx ? plane : 0;
  const size_t sizes[11] = {
      row_part_floats(p.rs, npairs),
      mode == 2 ? static_cast<size_t>(p.grid_outer) * MAX_NOUTER : 0,
      mode ? dm_floats(p.nc, LW) : 0,
      rmx ? rowm_dm_floats(p.r, rmx) : 0,
      psi, psi, w, w, rowm, rowm,
      pair_record_floats(npairs),
  };
  float* ptrs[11];
  const size_t off = carve(sizes, base, ptrs);
  if (s)
    *s = Scratch{ptrs[0], ptrs[1], ptrs[2], ptrs[3], ptrs[4], ptrs[5],
                 ptrs[6], ptrs[7], ptrs[8], ptrs[9], ptrs[10]};
  return off;
}

template <int D>
const void* outer_fn() {
  return reinterpret_cast<const void*>(outer_bwd_kernel<D>);
}

cudaError_t outer_stage(int d, const Plan& p, const float* cr, const float* ci,
                        float* wr, float* wi, const float* ksr,
                        const float* ksi, const float* mor, const float* moi,
                        float* part, cudaStream_t st) {
  const long be = static_cast<long>(p.r / d) * LANES;
  switch (d) {
    case 2:
      outer_bwd_kernel<2><<<p.grid_outer, THREADS, 0, st>>>(cr, ci, wr, wi, ksr, ksi, mor, moi, be, part);
      break;
    case 4:
      outer_bwd_kernel<4><<<p.grid_outer, THREADS, 0, st>>>(cr, ci, wr, wi, ksr, ksi, mor, moi, be, part);
      break;
    case 8:
      outer_bwd_kernel<8><<<p.grid_outer, THREADS, 0, st>>>(cr, ci, wr, wi, ksr, ksi, mor, moi, be, part);
      break;
    case 16:
      outer_bwd_kernel<16><<<p.grid_outer, THREADS, 0, st>>>(cr, ci, wr, wi, ksr, ksi, mor, moi, be, part);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tcng_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of scratch that tcng_zzrx_bwd (mode 0: no lane matrix, 1: with
// it; rmx > 0: with the row kron) or tcng_grand_zzrx_bwd (mode 2, rmx 0)
// needs for these shapes; -1 for a shape the stages do not take.
long tcng_zzrx_bwd_scratch(int r, int nkernel, int npairs, int mode, int rmx) {
  Plan p;
  if (npairs < 0 || rmx < 0 || !make_plan(r, nkernel - rmx, &p)) return -1;
  return static_cast<long>(layout(p, npairs, mode, rmx, nullptr, nullptr));
}

// K3.  yr/yi: the layer's (r, 128) output planes (post-lane when mr is
// given); ctr/cti: cotangent planes; dsr/dsi: (r, 128) output; grads:
// (npairs + nkernel - rmx) = (dzz, dth of the low bits); dm: (2, 128, 128)
// = (dmr, dmi) or null without lane; dm7: (2, R, R) = (dm7r, dm7i) or null
// with rmx = 0; zzth (npairs); shifts (npairs, 2) = (n-1-a, n-1-b); th
// (nkernel); mr/mi (128, 128) lane planes or null; m7r/m7i (R, R) unitary
// row-kron planes, R = 2^rmx, or null; scratch of tcng_zzrx_bwd_scratch
// floats.  With the lane, y, ct, the lane planes and the scratch are
// 16-byte aligned.  Returns the first CUDA error, 0 on success.
int tcng_zzrx_bwd(const float* yr, const float* yi, const float* ctr,
                  const float* cti, float* dsr, float* dsi, float* grads,
                  float* dm, float* dm7, const float* zzth, const int* shifts,
                  int npairs, const float* th, int nkernel, const float* mr,
                  const float* mi, const float* m7r, const float* m7i,
                  int rmx, float* scratch, int r, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Plan p;
  if (npairs < 0 || rmx < 0 || !make_plan(r, nkernel - rmx, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mr != nullptr && !all_aligned16({yr, yi, ctr, cti, mr, mi, scratch}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  Scratch s;
  layout(p, npairs, mr ? 1 : 0, rmx, scratch, &s);
  cudaError_t err = row_stage_prepare(p.rs, npairs);
  if (err == cudaSuccess && mr != nullptr) err = lane_stage_prepare();
  if (err == cudaSuccess) err = pair_records(p.rs, shifts, npairs, s.rec, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float *psr = yr, *psi = yi, *cr = ctr, *ci = cti;
  // where the first of two row passes writes: in place once psi and ct are
  // in scratch, else into scratch (the caller's planes stay untouched)
  float *mpr = s.pr, *mpi = s.pi, *mcr = s.wr, *mci = s.wi;
  if (mr != nullptr) {
    err = adjoint_lane_stage(r, LW, yr, yi, ctr, cti, mr, mi, s.pr, s.pi, s.wr, s.wi, s.part_dm,
                             dm, MM, p.nc, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    psr = s.pr;
    psi = s.pi;
    cr = s.wr;
    ci = s.wi;
  }
  if (rmx > 0) {
    // K14: x = M7^dagger psi into s.pr (in place after the lane stage),
    // ct' = M7^T ct into s.v; then dM7 from ct (not yet walked) and x
    err = rowm_apply<true>(psr, psi, cr, ci, s.pr, s.pi, s.vr, s.vi, m7r, m7i,
                           r, nkernel, rmx, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = rowm_dm(cr, ci, s.pr, s.pi, s.part_m7, dm7, r, nkernel, rmx, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    psr = s.pr;
    psi = s.pi;
    cr = mcr = s.vr;
    ci = mci = s.vi;
  }
  return static_cast<int>(adjoint_row_stage(p.rs, psr, psi, cr, ci, mpr, mpi, mcr, mci, nullptr,
                                            nullptr, dsr, dsi, s.part_row, s.rec, zzth, npairs,
                                            th + rmx, grads, st));
}

// The stages' plan at these shapes, for the record: five records of 8
// (kernel_record: CTAs, threads, shared bytes, CTAs an SM, registers, local
// bytes, x1, x2): the lane pair (x1, x2 = the tile's rows and columns), dM
// (x1 = chunks, x2 = rows a chunk), the first row pass and the last (x1 =
// tile elements, x2 = the pass's row bits; the first has 0 CTAs when there
// is one pass) and K4's outer stage (x1 = D, x2 = nouter; 0 CTAs where K4
// has none: rmx > 0 or D outside 2..16).
int tcng_zzrx_bwd_plan(int r, int nkernel, int npairs, int rmx, long* out) {
  Plan p;
  if (npairs < 0 || rmx < 0 || !make_plan(r, nkernel - rmx, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = kernel_record(reinterpret_cast<const void*>(wide_nt_kernel<2, true>),
                                  prod_ctas(r, LW), THREADS, prod_smem<2>(), P_T, P_T, out);
  if (err == cudaSuccess)
    err = kernel_record(reinterpret_cast<const void*>(wide_dm_kernel), static_cast<long>(p.nc) << 2,
                        THREADS, DM_SMEM, p.nc, r / p.nc, out + 8);
  for (int k = 0; k < 2 && err == cudaSuccess; ++k) {
    const bool last = k == 1;
    const RowPass& rp = last ? last_pass(p.rs) : p.rs.pass[0];
    const bool runs = last || p.rs.npass == 2;
    err = kernel_record(row_pass_fn(last), runs ? row_ctas(p.rs) : 0, row_threads(p.rs),
                        row_pass_smem(rp, npairs, last), 1L << rp.tb, runs ? rp.nb : 0, out + 16 + 8 * k);
  }
  const int d = r >> nkernel;
  const bool runs = rmx == 0 && d >= 2 && d <= (1 << MAX_NOUTER);
  const void* fn = !runs ? outer_fn<2>() : d == 2 ? outer_fn<2>() : d == 4 ? outer_fn<4>()
                 : d == 8 ? outer_fn<8>() : outer_fn<16>();
  if (err == cudaSuccess)
    err = kernel_record(fn, runs ? p.grid_outer : 0, THREADS, 0, d, runs ? ilog2(d) : 0, out + 32);
  return static_cast<int>(err);
}

// The row-kron stages' plan at these shapes, for the record: out[0..7) of
// K14a (CW, tiles, grid, shared bytes, CTAs an SM, registers, local bytes)
// and out[7..15) of K14b's dM7 (tile edge, tiles, chunks, columns a chunk,
// shared bytes, CTAs an SM, registers, local bytes).
int tcng_rowm_bwd_plan(int rmx, int r, long* out) {
  cudaError_t err = rowm_apply_plan<true>(rmx, r, out);
  if (err == cudaSuccess) err = rowm_dm_plan(rmx, r, out + 7);
  return static_cast<int>(err);
}

// The dM stage alone at r rows with nc row chunks (a power of two that
// divides r): dm (2, 128, 128) <- psi^T ct; part of 2 * nc * 128 * 128
// floats; every plane 16-byte aligned.  For measuring the chunk rule
// (dm_chunks) on the card; the kernels above take the rule's count.
int tcng_lane_dm(const float* pr, const float* pi, const float* ctr, const float* cti,
                 float* part, float* dm, int r, int nc, void* stream) {
  if (r < 1 || nc < 1 || (nc & (nc - 1)) || r % nc) return static_cast<int>(cudaErrorInvalidValue);
  if (!all_aligned16({pr, pi, ctr, cti, part, dm})) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err = lane_stage_prepare();
  if (err == cudaSuccess)
    err = wide_dm(pr, pi, ctr, cti, part, dm, MM, r, LW, nc, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// K4.  ksr/ksi (L, r, 128) post-lane, pre-outer residuals; ctr/cti (r, 128)
// seed cotangent; dsr/dsi (r, 128) output (also the walked cotangent
// between layers); grads (L, npairs + nkernel + nouter) = (dzz, dth,
// dth_outer) a layer; dm (2, L, 128, 128) = (dmr, dmi); zzth (L, npairs);
// th (L, nkernel); mor/moi (L, D, D) outer rx krons with D = r >> nkernel
// in {2, 4, 8, 16}; mlr/mli (L, 128, 128) unitary lane planes; every plane
// but the angles and the outer planes 16-byte aligned.
int tcng_grand_zzrx_bwd(const float* ksr, const float* ksi, const float* ctr,
                        const float* cti, float* dsr, float* dsi, float* grads,
                        float* dm, const float* zzth, const int* shifts,
                        int npairs, const float* th, int nkernel, int L,
                        const float* mor, const float* moi, const float* mlr,
                        const float* mli, float* scratch, int r, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Plan p;
  if (npairs < 0 || L < 1 || !make_plan(r, nkernel, &p)) return static_cast<int>(cudaErrorInvalidValue);
  const int d = r >> nkernel;
  if (d < 2 || d > (1 << MAX_NOUTER)) return static_cast<int>(cudaErrorInvalidValue);
  if (!all_aligned16({ksr, ksi, ctr, cti, dsr, dsi, dm, mlr, mli, scratch}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int nouter = ilog2(d);
  const int w = npairs + nkernel + nouter;
  const size_t plane = static_cast<size_t>(r) * LANES;
  Scratch s;
  layout(p, npairs, 2, 0, scratch, &s);
  cudaError_t err = lane_stage_prepare();
  if (err == cudaSuccess) err = row_stage_prepare(p.rs, npairs);
  if (err == cudaSuccess) err = pair_records(p.rs, shifts, npairs, s.rec, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int l = L - 1; l >= 0; --l) {
    const float* kr = ksr + l * plane;
    const float* ki = ksi + l * plane;
    // w = mo^T ct into ds (in place after the first layer), dth_outer
    err = outer_stage(d, p, l == L - 1 ? ctr : dsr, l == L - 1 ? cti : dsi, dsr, dsi, kr, ki,
                      mor + l * d * d, moi + l * d * d, s.part_outer, st);
    if (err == cudaSuccess)
      err = colsum_tree(s.part_outer, p.grid_outer, nouter, grads + l * w + npairs + nkernel, st);
    // psi = k @ conj(M)^T, w @ M^T and dM = psi^T w
    if (err == cudaSuccess)
      err = adjoint_lane_stage(r, LW, kr, ki, dsr, dsi, mlr + static_cast<size_t>(l) * MM,
                               mli + static_cast<size_t>(l) * MM, s.pr, s.pi, s.wr, s.wi, s.part_dm,
                               dm + static_cast<size_t>(l) * MM, static_cast<long>(L) * MM, p.nc, st);
    // the rx and zz adjoint in place on (psi, w), ds into the ds planes
    if (err == cudaSuccess)
      err = adjoint_row_stage(p.rs, s.pr, s.pi, s.wr, s.wi, s.pr, s.pi, s.wr, s.wi, nullptr, nullptr,
                              dsr, dsi, s.part_row, s.rec, zzth + l * npairs, npairs, th + l * nkernel,
                              grads + l * w, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
