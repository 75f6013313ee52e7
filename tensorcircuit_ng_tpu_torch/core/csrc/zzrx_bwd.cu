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
// at n = 20 (4 planes of 4 MB between passes) stay in the 50 MB L2:
//   lane pass (lane_bwd_kernel, lane.cuh): 16 rows x 128 lanes a CTA;
//     both complex right-products by M^T (the un-lane of y and the ct
//     walk) share the M chunks streamed through shared memory;
//   dM pass (dm_partial_kernel, lane.cuh): a 32 x 128 slab of dM over a
//     chunk of rows a CTA, one partial per chunk;
//   row pass (zzrx_bwd_row_kernel): all rows of a block for a few lanes a
//     CTA, psi and ct both in shared memory (128 KB), the nkernel
//     butterflies in place on both, then the phase walk and dzz;
//   outer pass (outer_bwd_kernel<D>, K4 only): one thread per in-block
//     position holds its D elements in registers.
// Sums over the whole state (dM, dzz, dth, dth_outer) are written as one
// partial per CTA (block sums in a fixed shuffle-tree order) and reduced by
// colsum_kernel in a fixed order: no float atomics, so two runs give the
// same gradient bit for bit.  K4 is one C entry point that launches the
// stage kernels for each layer in order on the caller's stream (the outer
// stage is a grid-wide dependency).
// Bound at n = 20: operations.  The lane stage is three complex 128-deep
// products per amplitude (un-lane, ct walk, dM), 3 * 8 * 128 flops, about
// 3.2 GFLOP a layer against 67 TFLOP/s float32 outside the tensor cores;
// the state moves ~25 MB a layer.  Plain f32 FMAs, no fast-math.

#include "lane.cuh"
#include "rowm.cuh"

namespace {

// row pass tile: RB * TL complex elements of psi and of ct (4 planes, 128 KB)
constexpr int TILE_ELEMS = 8192;
// outer pass: D <= 16 (nouter <= 4)
constexpr int MAX_NOUTER = 4;

// The rx and zz adjoint of one layer on an RB x TL tile (all rows of a
// block, TL lanes) of psi (pre-lane state) and ct.  Writes ds and one
// partial a CTA: part[blk] = (dzz[0..npairs), dth[0..nkernel)).
__global__ void __launch_bounds__(THREADS)
zzrx_bwd_row_kernel(const float* psr, const float* psi, const float* ctr,
                    const float* cti, float* dsr, float* dsi, float* part,
                    const float* __restrict__ zzth,
                    const int* __restrict__ shifts, int npairs,
                    const float* __restrict__ th, int nkernel, int ltl) {
  extern __shared__ float smem[];
  const int tl = 1 << ltl;
  const int rb = 1 << nkernel;
  const int elems = rb << ltl;
  float* tr = smem;
  float* ti = tr + elems;
  float* cr = ti + elems;
  float* ci = cr + elems;
  float* red = ci + elems;
  float* zth = red + NWARPS;
  int* sh = reinterpret_cast<int*>(zth + npairs);
  for (int k = threadIdx.x; k < npairs; k += blockDim.x) {
    zth[k] = zzth[k];
    sh[2 * k] = shifts[2 * k];
    sh[2 * k + 1] = shifts[2 * k + 1];
  }
  const int tiles = LANES >> ltl;
  const long j = blockIdx.x / tiles;  // row block
  const int lane0 = (blockIdx.x % tiles) << ltl;
  float* mypart = part + static_cast<long>(blockIdx.x) * (npairs + nkernel);
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const long off = (j * rb + (e >> ltl)) * LANES + lane0 + (e & (tl - 1));
    tr[e] = psr[off];
    ti[e] = psi[off];
    cr[e] = ctr[off];
    ci[e] = cti[off];
  }
  __syncthreads();
  // rx, last kernel bit first: un-apply [[c, -i s], [-i s, c]] from psi
  // (the butterfly with +s), take dth, walk ct through the transpose
  const int half = elems >> 1;
  for (int ql = nkernel - 1; ql >= 0; --ql) {
    const int ls = nkernel - 1 - ql;  // log2 of the row stride
    float sn, c;
    sincosf(0.5f * th[ql], &sn, &c);
    float s1 = 0.f, s2 = 0.f;
    for (int p = threadIdx.x; p < half; p += blockDim.x) {
      const int pr = p >> ltl;
      const int l = p & (tl - 1);
      const int lo = ((pr >> ls) << (ls + 1)) | (pr & ((1 << ls) - 1));
      const int elo = (lo << ltl) | l;
      const int ehi = elo + (1 << (ls + ltl));
      const float ar = tr[elo], ai = ti[elo], br = tr[ehi], bi = ti[ehi];
      const float nar = c * ar - sn * bi, nai = c * ai + sn * br;
      const float nbr = c * br - sn * ai, nbi = c * bi + sn * ar;
      tr[elo] = nar;
      ti[elo] = nai;
      tr[ehi] = nbr;
      ti[ehi] = nbi;
      const float xr = cr[elo], xi = ci[elo], zr = cr[ehi], zi = ci[ehi];
      s1 += xr * nar - xi * nai + zr * nbr - zi * nbi;
      s2 += zr * nai + zi * nar + xr * nbi + xi * nbr;
      cr[elo] = c * xr + sn * zi;
      ci[elo] = c * xi - sn * zr;
      cr[ehi] = c * zr + sn * xi;
      ci[ehi] = c * zi - sn * xr;
    }
    // the block sums are also the barrier between stages
    s1 = block_sum(s1, red);
    s2 = block_sum(s2, red);
    if (threadIdx.x == 0) mypart[npairs + ql] = -0.5f * sn * s1 + 0.5f * c * s2;
  }
  // zz: ds = ct * e^{-i expo/2} (a diagonal map is its own transpose);
  // h = ct_r z_i + ct_i z_r replaces psi's real plane for the dzz sums
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const long off = (j * rb + (e >> ltl)) * LANES + lane0 + (e & (tl - 1));
    const unsigned idx = static_cast<unsigned>(off);
    float expo = 0.f;
    for (int k = 0; k < npairs; ++k) {
      const unsigned x = ((idx >> sh[2 * k]) ^ (idx >> sh[2 * k + 1])) & 1u;
      expo += zth[k] * (1.f - 2.f * static_cast<float>(x));
    }
    float s, cc;
    sincosf(0.5f * expo, &s, &cc);
    const float xr = cr[e], xi = ci[e];
    tr[e] = xr * ti[e] + xi * tr[e];
    dsr[off] = cc * xr + s * xi;
    dsi[off] = cc * xi - s * xr;
  }
  __syncthreads();
  for (int k = 0; k < npairs; ++k) {
    float acc = 0.f;
    for (int e = threadIdx.x; e < elems; e += blockDim.x) {
      const long off = (j * rb + (e >> ltl)) * LANES + lane0 + (e & (tl - 1));
      const unsigned idx = static_cast<unsigned>(off);
      const unsigned x = ((idx >> sh[2 * k]) ^ (idx >> sh[2 * k + 1])) & 1u;
      acc += tr[e] * (1.f - 2.f * static_cast<float>(x));
    }
    acc = block_sum(acc, red);
    if (threadIdx.x == 0) mypart[k] = 0.5f * acc;
  }
}

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
  int r, rb, ltl, grid_row, grid_outer;
  size_t row_smem;
};

Plan make_plan(int r, int nkernel, int npairs) {
  Plan p;
  p.r = r;
  p.rb = 1 << nkernel;
  int tl = TILE_ELEMS / p.rb;
  if (tl > LANES) tl = LANES;
  if (tl < 1) tl = 1;
  p.ltl = ilog2(tl);
  p.grid_row = (r / p.rb) * (LANES / tl);
  p.row_smem = sizeof(float) * (4 * static_cast<size_t>(p.rb) * tl + NWARPS + npairs) +
               sizeof(int) * 2 * npairs;
  p.grid_outer = static_cast<int>((static_cast<long>(p.rb) * LANES + THREADS - 1) / THREADS);
  return p;
}

struct Scratch {
  float *part_row, *part_outer, *part_dm, *part_m7, *pr, *pi, *wr, *wi, *vr, *vi;
};

// mode 0: K3 without lane, 1: K3 with lane, 2: K4; rmx > 0: K3 with the
// row kron (the row stage then walks nkernel = the low bits only).
// Returns the floats needed; fills s when base is given.
size_t layout(const Plan& p, int npairs, int nkernel, int mode, int rmx,
              float* base, Scratch* s) {
  const size_t plane = static_cast<size_t>(p.r) * LANES;
  const size_t lane = mode ? plane : 0, rowm = rmx ? plane : 0;
  const size_t either = (mode || rmx) ? plane : 0;
  size_t sizes[10] = {
      static_cast<size_t>(p.grid_row) * (npairs + nkernel),
      mode == 2 ? static_cast<size_t>(p.grid_outer) * MAX_NOUTER : 0,
      mode ? dm_partial_floats(p.r) : 0,
      rmx ? rowm_dm_floats(p.r, rmx) : 0,
      either, either, lane, lane, rowm, rowm,
  };
  size_t off = 0;
  float* ptrs[10];
  for (int i = 0; i < 10; ++i) {
    ptrs[i] = base ? base + off : nullptr;
    off += (sizes[i] + 31) & ~static_cast<size_t>(31);  // 128-byte aligned parts
  }
  if (s) {
    s->part_row = ptrs[0];
    s->part_outer = ptrs[1];
    s->part_dm = ptrs[2];
    s->part_m7 = ptrs[3];
    s->pr = ptrs[4];
    s->pi = ptrs[5];
    s->wr = ptrs[6];
    s->wi = ptrs[7];
    s->vr = ptrs[8];
    s->vi = ptrs[9];
  }
  return off;
}

// Lane stage of the adjoint: s.pr/pi <- y @ conj(M)^T, s.wr/wi <- ct @ M^T,
// dm planes (dm_out, dm_out + dm_stride) <- psi^T ct.
cudaError_t lane_stage(const Plan& p, const float* yr, const float* yi,
                       const float* ctr, const float* cti, const float* mr,
                       const float* mi, const Scratch& s, float* dm_out,
                       long dm_stride, cudaStream_t st) {
  return lane_bwd_stage(p.r, yr, yi, ctr, cti, mr, mi, s.pr, s.pi, s.wr, s.wi,
                        s.part_dm, dm_out, dm_stride, st);
}

// Row stage: ds <- rx and zz adjoint of (psi, ct); grads[0..npairs+nkernel)
// <- (dzz, dth).
cudaError_t row_stage(const Plan& p, const float* psr, const float* psi,
                      const float* ctr, const float* cti, float* dsr,
                      float* dsi, const Scratch& s, float* grads,
                      const float* zzth, const int* shifts, int npairs,
                      const float* th, int nkernel, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      zzrx_bwd_row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.row_smem));
  if (err != cudaSuccess) return err;
  zzrx_bwd_row_kernel<<<p.grid_row, THREADS, p.row_smem, st>>>(
      psr, psi, ctr, cti, dsr, dsi, s.part_row, zzth, shifts, npairs, th,
      nkernel, p.ltl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int w = npairs + nkernel;
  return colsum(s.part_row, p.grid_row, w, grads, w, 0, st);
}

cudaError_t outer_stage(int d, const Plan& p, const float* cr, const float* ci,
                        float* wr, float* wi, const float* ksr,
                        const float* ksi, const float* mor, const float* moi,
                        float* part, cudaStream_t st) {
  const long be = static_cast<long>(p.rb) * LANES;
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
// needs for these shapes.
long tcng_zzrx_bwd_scratch(int r, int nkernel, int npairs, int mode, int rmx) {
  const Plan p = make_plan(r, nkernel - rmx, npairs);
  return static_cast<long>(layout(p, npairs, nkernel - rmx, mode, rmx, nullptr, nullptr));
}

// K3.  yr/yi: the layer's (r, 128) output planes (post-lane when mr is
// given); ctr/cti: cotangent planes; dsr/dsi: (r, 128) output; grads:
// (npairs + nkernel - rmx) = (dzz, dth of the low bits); dm: (2, 128, 128)
// = (dmr, dmi) or null without lane; dm7: (2, R, R) = (dm7r, dm7i) or null
// with rmx = 0; zzth (npairs); shifts (npairs, 2) = (n-1-a, n-1-b); th
// (nkernel); mr/mi (128, 128) lane planes or null; m7r/m7i (R, R) unitary
// row-kron planes, R = 2^rmx, or null; scratch of tcng_zzrx_bwd_scratch
// floats.  Returns the first CUDA error, 0 on success.
int tcng_zzrx_bwd(const float* yr, const float* yi, const float* ctr,
                  const float* cti, float* dsr, float* dsi, float* grads,
                  float* dm, float* dm7, const float* zzth, const int* shifts,
                  int npairs, const float* th, int nkernel, const float* mr,
                  const float* mi, const float* m7r, const float* m7i,
                  int rmx, float* scratch, int r, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nlow = nkernel - rmx;  // the bits the row stage walks
  const Plan p = make_plan(r, nlow, npairs);
  Scratch s;
  layout(p, npairs, nlow, mr ? 1 : 0, rmx, scratch, &s);
  const float *psr = yr, *psi = yi, *cr = ctr, *ci = cti;
  cudaError_t err = cudaSuccess;
  if (mr != nullptr) {
    err = lane_stage(p, yr, yi, ctr, cti, mr, mi, s, dm, MM, st);
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
    cr = s.vr;
    ci = s.vi;
  }
  return static_cast<int>(row_stage(p, psr, psi, cr, ci, dsr, dsi, s, grads,
                                    zzth, shifts, npairs, th + rmx, nlow, st));
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

// K4.  ksr/ksi (L, r, 128) post-lane, pre-outer residuals; ctr/cti (r, 128)
// seed cotangent; dsr/dsi (r, 128) output (also the walked cotangent
// between layers); grads (L, npairs + nkernel + nouter) = (dzz, dth,
// dth_outer) a layer; dm (2, L, 128, 128) = (dmr, dmi); zzth (L, npairs);
// th (L, nkernel); mor/moi (L, D, D) outer rx krons with D = r >> nkernel
// in {2, 4, 8, 16}; mlr/mli (L, 128, 128) unitary lane planes.
int tcng_grand_zzrx_bwd(const float* ksr, const float* ksi, const float* ctr,
                        const float* cti, float* dsr, float* dsi, float* grads,
                        float* dm, const float* zzth, const int* shifts,
                        int npairs, const float* th, int nkernel, int L,
                        const float* mor, const float* moi, const float* mlr,
                        const float* mli, float* scratch, int r, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(r, nkernel, npairs);
  const int d = r / p.rb;
  if (d < 2 || d > (1 << MAX_NOUTER)) return static_cast<int>(cudaErrorInvalidValue);
  const int nouter = ilog2(d);
  const int w = npairs + nkernel + nouter;
  const size_t plane = static_cast<size_t>(r) * LANES;
  Scratch s;
  layout(p, npairs, nkernel, 2, 0, scratch, &s);
  for (int l = L - 1; l >= 0; --l) {
    const float* kr = ksr + l * plane;
    const float* ki = ksi + l * plane;
    cudaError_t err = outer_stage(
        d, p, l == L - 1 ? ctr : dsr, l == L - 1 ? cti : dsi, dsr, dsi, kr, ki,
        mor + l * d * d, moi + l * d * d, s.part_outer, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = colsum(s.part_outer, p.grid_outer, nouter, grads + l * w + npairs + nkernel,
                 nouter, 0, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = lane_stage(p, kr, ki, dsr, dsi, mlr + static_cast<size_t>(l) * MM,
                     mli + static_cast<size_t>(l) * MM, s, dm + static_cast<size_t>(l) * MM,
                     static_cast<long>(L) * MM, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = row_stage(p, s.pr, s.pi, s.wr, s.wi, dsr, dsi, s, grads + l * w,
                    zzth + l * npairs, shifts, npairs, th + l * nkernel, nkernel, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
