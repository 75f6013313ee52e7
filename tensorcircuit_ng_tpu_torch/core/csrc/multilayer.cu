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
//      per row bit in reverse: un-apply rx from psi, dth_q from the two
//      sums -1/2 s Re S1 + 1/2 c Im S2, walk ct by rx^T = rx           (rx)
//      dzz_k = 1/2 sum h z_a z_b, h = ct_r z_i + ct_i z_r; ct <- ct * phase;
//      x = conj(phase) * z                                            (zz)
//    and returns ds = ct, (dzz, dth) a layer and dM.
//
// Design.  The TPU keeps the whole state (8 MB of planes at n = 20) resident
// in VMEM across the L grid steps; a CTA holds at most 227 KB.  So, as K2/K4
// do, one C entry point launches stage kernels layer by layer on the
// caller's stream, and the state lives in the 50 MB L2 between them:
//   row stage (ml_row_fwd_kernel / ml_row_bwd_kernel): a CTA holds all
//     2^nrow rows for TL = 8192 / 2^nrow lanes (2 lanes at nrow = 12): 64 KB
//     of planes forward, 128 KB with the cotangent backward.  The zz sign of
//     each pair comes from the XOR of two flat-index bits (no sign
//     matrices), the rx butterflies run in place with a barrier between
//     bits; backward the dth and dzz sums are block sums (a warp xor tree,
//     the warps in order) into one partial a CTA;
//   lane stage (wide_lane_kernel, lane.cuh): the complex (rows x W) @
//     (W x W) product on 32 x 128 output tiles, written by hand on plain FMAs
//     (the Pallas body does it on the MXU); backward two products (un-lane
//     with conj(M)^T, ct walk with M^T) and dM = psi^T ct by row-chunk
//     partials (wide_dm_kernel).
// Every sum across CTAs (dth, dzz, dM) is a per-CTA partial added by
// colsum_kernel in a fixed order: no atomics, two runs agree bit for bit.
// The TPU's "interleave sweep" (rotating the top row bit to the bottom,
// since Mosaic cannot roll), the host-built sign matrices and the 128-column
// pair padding are layout devices of the TPU and are not carried over.
// Bound at n = 20, L = 4: operations.  The lane product is 8 W flops an
// amplitude, 2.15 GFLOP a layer at W = 256 (three a layer backward) against
// 67 TFLOP/s float32 outside the tensor cores; the state moves 16.8 MB a
// layer forward.  Plain f32 FMAs, no fast-math.

#include "lane.cuh"

namespace {

// row tile: 2^nrow x TL complex elements (8192: 64 KB of two planes)
constexpr int ML_TILE = 8192;
constexpr int ML_MAX_NROW = 12;
constexpr int ML_MAX_PAIRS = 128;

struct MlPlan {
  int r, lw, ltl, grid_row;
  size_t fwd_smem, bwd_smem;
};

// false for a shape the kernels do not take.
bool ml_plan(int r, int lanes, int nrow, int npairs, MlPlan* p) {
  if (nrow < 1 || nrow > ML_MAX_NROW || r != (1 << nrow)) return false;
  const int lw = ilog2(lanes);
  if ((1 << lw) != lanes || lw < 7 || lw > 10) return false;
  if (npairs < 0 || npairs > ML_MAX_PAIRS) return false;
  int tl = ML_TILE / r;
  if (tl > lanes) tl = lanes;
  p->r = r;
  p->lw = lw;
  p->ltl = ilog2(tl);
  p->grid_row = lanes / tl;
  const size_t consts = sizeof(float) * (npairs + 2 * nrow) + sizeof(int) * 2 * npairs;
  p->fwd_smem = sizeof(float) * 2 * static_cast<size_t>(r) * tl + consts;
  p->bwd_smem = sizeof(float) * (4 * static_cast<size_t>(r) * tl + NWARPS) + consts;
  return true;
}

// Shared constants of a row kernel after `planes` tile planes: the layer's
// zz angles, (cos, sin) of the half rx angles and the pair shifts.
struct RowConsts {
  float* zth;
  float* cs;
  int* sh;
};

__device__ RowConsts load_consts(float* base, const float* zzth,
                                 const int* shifts, int npairs,
                                 const float* th, int nrow) {
  RowConsts k;
  k.zth = base;
  k.cs = k.zth + npairs;
  k.sh = reinterpret_cast<int*>(k.cs + 2 * nrow);
  for (int j = threadIdx.x; j < npairs; j += blockDim.x) {
    k.zth[j] = zzth[j];
    k.sh[2 * j] = shifts[2 * j];
    k.sh[2 * j + 1] = shifts[2 * j + 1];
  }
  for (int q = threadIdx.x; q < nrow; q += blockDim.x)
    sincosf(0.5f * th[q], &k.cs[2 * q + 1], &k.cs[2 * q]);
  return k;
}

// The zz exponent sum_k th_k (1 - 2 (bit_a ^ bit_b)) at flat index idx.
__device__ __forceinline__ float zz_expo(unsigned idx, const RowConsts& k,
                                         int npairs) {
  float expo = 0.f;
  for (int j = 0; j < npairs; ++j) {
    const unsigned x = ((idx >> k.sh[2 * j]) ^ (idx >> k.sh[2 * j + 1])) & 1u;
    expo += k.zth[j] * (1.f - 2.f * static_cast<float>(x));
  }
  return expo;
}

// Offset of tile element e (row e >> ltl, lane e & (TL-1) of the CTA's TL
// lanes) in the (r, W) planes: also its flat index.
__device__ __forceinline__ long ml_off(int e, int ltl, int lw) {
  return (static_cast<long>(e >> ltl) << lw) + (blockIdx.x << ltl) +
         (e & ((1 << ltl) - 1));
}

// Tile elements of pair p of the stage on the row bit of stride 2^ls.
__device__ __forceinline__ void ml_pair(int p, int ls, int ltl, int* elo,
                                        int* ehi) {
  const int pr = p >> ltl;
  const int lo = ((pr >> ls) << (ls + 1)) | (pr & ((1 << ls) - 1));
  *elo = (lo << ltl) | (p & ((1 << ltl) - 1));
  *ehi = *elo + (1 << (ls + ltl));
}

// K9's row stage of one layer: x -> y = rx...rx (phase * x), all rows of
// the CTA's TL lanes.  x and y may alias.
__global__ void __launch_bounds__(THREADS)
ml_row_fwd_kernel(const float* xr, const float* xi, float* yr, float* yi,
                  const float* __restrict__ zzth, const int* __restrict__ shifts,
                  int npairs, const float* __restrict__ th, int nrow, int lw,
                  int ltl) {
  extern __shared__ float smem[];
  const int elems = (1 << nrow) << ltl;
  float* tr = smem;
  float* ti = tr + elems;
  const RowConsts k = load_consts(ti + elems, zzth, shifts, npairs, th, nrow);
  __syncthreads();
  // load + phase e^{-i expo/2}
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const long off = ml_off(e, ltl, lw);
    float s, c;
    sincosf(0.5f * zz_expo(static_cast<unsigned>(off), k, npairs), &s, &c);
    const float ar = xr[off], ai = xi[off];
    tr[e] = c * ar + s * ai;
    ti[e] = c * ai - s * ar;
  }
  __syncthreads();
  // rx(th_q) = [[c, -i s], [-i s, c]] on the row bit of stride 2^(nrow-1-q)
  const int half = elems >> 1;
  for (int q = 0; q < nrow; ++q) {
    const int ls = nrow - 1 - q;
    const float c = k.cs[2 * q], sn = k.cs[2 * q + 1];
    for (int p = threadIdx.x; p < half; p += blockDim.x) {
      int elo, ehi;
      ml_pair(p, ls, ltl, &elo, &ehi);
      const float ar = tr[elo], ai = ti[elo], br = tr[ehi], bi = ti[ehi];
      tr[elo] = c * ar + sn * bi;
      ti[elo] = c * ai - sn * br;
      tr[ehi] = c * br + sn * ai;
      ti[ehi] = c * bi - sn * ar;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const long off = ml_off(e, ltl, lw);
    yr[off] = tr[e];
    yi[off] = ti[e];
  }
}

// K10's row stage of one layer, from psi (the pre-lane state) and ct (the
// walked cotangent): writes the layer input x, ds and one partial a CTA,
// part[blk] = (dzz[0..npairs), dth[0..nrow)).  No output may alias an input.
__global__ void __launch_bounds__(THREADS)
ml_row_bwd_kernel(const float* psr, const float* psi, const float* ctr,
                  const float* cti, float* xr, float* xi, float* dsr,
                  float* dsi, float* part, const float* __restrict__ zzth,
                  const int* __restrict__ shifts, int npairs,
                  const float* __restrict__ th, int nrow, int lw, int ltl) {
  extern __shared__ float smem[];
  const int elems = (1 << nrow) << ltl;
  float* tr = smem;
  float* ti = tr + elems;
  float* cr = ti + elems;
  float* ci = cr + elems;
  float* red = ci + elems;
  const RowConsts k = load_consts(red + NWARPS, zzth, shifts, npairs, th, nrow);
  float* mypart = part + static_cast<long>(blockIdx.x) * (npairs + nrow);
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const long off = ml_off(e, ltl, lw);
    tr[e] = psr[off];
    ti[e] = psi[off];
    cr[e] = ctr[off];
    ci[e] = cti[off];
  }
  __syncthreads();
  // rx, last row bit first: un-apply [[c, -i s], [-i s, c]] from psi (the
  // butterfly with +s), the two dth sums, walk ct through the transpose
  const int half = elems >> 1;
  for (int q = nrow - 1; q >= 0; --q) {
    const int ls = nrow - 1 - q;
    const float c = k.cs[2 * q], sn = k.cs[2 * q + 1];
    float s1 = 0.f, s2 = 0.f;
    for (int p = threadIdx.x; p < half; p += blockDim.x) {
      int elo, ehi;
      ml_pair(p, ls, ltl, &elo, &ehi);
      const float ar = tr[elo], ai = ti[elo], br = tr[ehi], bi = ti[ehi];
      const float nar = c * ar - sn * bi, nai = c * ai + sn * br;
      const float nbr = c * br - sn * ai, nbi = c * bi + sn * ar;
      tr[elo] = nar;
      ti[elo] = nai;
      tr[ehi] = nbr;
      ti[ehi] = nbi;
      const float ur = cr[elo], ui = ci[elo], vr = cr[ehi], vi = ci[ehi];
      s1 += ur * nar - ui * nai + vr * nbr - vi * nbi;
      s2 += vr * nai + vi * nar + ur * nbi + ui * nbr;
      cr[elo] = c * ur + sn * vi;
      ci[elo] = c * ui - sn * vr;
      cr[ehi] = c * vr + sn * ui;
      ci[ehi] = c * vi - sn * ur;
    }
    // the block sums are also the barrier between stages
    s1 = block_sum(s1, red);
    s2 = block_sum(s2, red);
    if (threadIdx.x == 0) mypart[npairs + q] = -0.5f * sn * s1 + 0.5f * c * s2;
  }
  // zz: ds = ct * phase (a diagonal map is its own transpose), x =
  // conj(phase) * z; h = ct_r z_i + ct_i z_r replaces z for the dzz sums
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const long off = ml_off(e, ltl, lw);
    float s, c;
    sincosf(0.5f * zz_expo(static_cast<unsigned>(off), k, npairs), &s, &c);
    const float ur = cr[e], ui = ci[e], zr = tr[e], zi = ti[e];
    dsr[off] = c * ur + s * ui;
    dsi[off] = c * ui - s * ur;
    xr[off] = c * zr - s * zi;
    xi[off] = c * zi + s * zr;
    tr[e] = ur * zi + ui * zr;
  }
  __syncthreads();
  for (int j = 0; j < npairs; ++j) {
    float acc = 0.f;
    for (int e = threadIdx.x; e < elems; e += blockDim.x) {
      const unsigned idx = static_cast<unsigned>(ml_off(e, ltl, lw));
      const unsigned x = ((idx >> k.sh[2 * j]) ^ (idx >> k.sh[2 * j + 1])) & 1u;
      acc += tr[e] * (1.f - 2.f * static_cast<float>(x));
    }
    acc = block_sum(acc, red);
    if (threadIdx.x == 0) mypart[j] = 0.5f * acc;
  }
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct MlScratch {
  float *tr, *ti, *sr, *si, *wr, *wi, *part_row, *part_dm;
};

// Floats of scratch (bwd = 0: K9, 1: K10); fills s when base is given.
size_t ml_layout(const MlPlan& p, int npairs, int nrow, bool bwd, float* base,
                 MlScratch* s) {
  const size_t plane = static_cast<size_t>(p.r) << p.lw;
  const size_t sizes[8] = {
      plane, plane, bwd ? plane : 0, bwd ? plane : 0, bwd ? plane : 0,
      bwd ? plane : 0,
      bwd ? static_cast<size_t>(p.grid_row) * (npairs + nrow) : 0,
      bwd ? wide_dm_floats(p.r, p.lw) : 0,
  };
  float* ptrs[8];
  size_t off = 0;
  for (int i = 0; i < 8; ++i) {
    ptrs[i] = base ? base + off : nullptr;
    off += sizes[i];
  }
  if (s) *s = MlScratch{ptrs[0], ptrs[1], ptrs[2], ptrs[3], ptrs[4], ptrs[5], ptrs[6], ptrs[7]};
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
  return static_cast<long>(ml_layout(p, npairs, nrow, bwd != 0, nullptr, nullptr));
}

// K9.  sr/si (r, W) input planes, r = 2^nrow; yr/yi (r, W) output; zzth
// (L, npairs); shifts (npairs, 2) = (n-1-a, n-1-b); th (L, nrow); mr/mi
// (L, W, W) lane planes; scratch of tcng_ml_scratch(.., 0) floats.  Returns
// the first CUDA error (cudaErrorInvalidValue for a shape it does not
// take), 0 on success.
int tcng_ml_fwd(const float* sr, const float* si, float* yr, float* yi,
                const float* zzth, const int* shifts, int npairs,
                const float* th, int nrow, int L, const float* mr,
                const float* mi, float* scratch, int r, int lanes,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MlPlan p;
  if (L < 1 || !ml_plan(r, lanes, nrow, npairs, &p)) return static_cast<int>(cudaErrorInvalidValue);
  MlScratch s;
  ml_layout(p, npairs, nrow, false, scratch, &s);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(ml_row_fwd_kernel), p.fwd_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t ww = static_cast<size_t>(lanes) * lanes;
  for (int l = 0; l < L; ++l) {
    ml_row_fwd_kernel<<<p.grid_row, THREADS, p.fwd_smem, st>>>(
        l == 0 ? sr : yr, l == 0 ? si : yi, s.tr, s.ti, zzth + l * npairs,
        shifts, npairs, th + l * nrow, nrow, p.lw, p.ltl);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = wide_lane<0>(s.tr, s.ti, yr, yi, mr + l * ww, mi + l * ww, r, p.lw, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// K10.  yr/yi: K9's (r, W) output planes; ctr/cti: cotangent planes;
// dsr/dsi (r, W) output; grads (L, npairs + nrow) = (dzz, dth) a layer; dm
// (2, L, W, W) = (dmr, dmi); zzth, shifts, th, mr/mi as K9's (mr/mi
// unitary); scratch of tcng_ml_scratch(.., 1) floats.
int tcng_ml_bwd(const float* yr, const float* yi, const float* ctr,
                const float* cti, float* dsr, float* dsi, float* grads,
                float* dm, const float* zzth, const int* shifts, int npairs,
                const float* th, int nrow, int L, const float* mr,
                const float* mi, float* scratch, int r, int lanes,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MlPlan p;
  if (L < 1 || !ml_plan(r, lanes, nrow, npairs, &p)) return static_cast<int>(cudaErrorInvalidValue);
  MlScratch s;
  ml_layout(p, npairs, nrow, true, scratch, &s);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(ml_row_bwd_kernel), p.bwd_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t ww = static_cast<size_t>(lanes) * lanes;
  const int w = npairs + nrow;
  for (int l = L - 1; l >= 0; --l) {
    const float* ysr = l == L - 1 ? yr : s.sr;
    const float* ysi = l == L - 1 ? yi : s.si;
    const float* cr = l == L - 1 ? ctr : dsr;
    const float* ci = l == L - 1 ? cti : dsi;
    // psi = y @ conj(M)^T -> (tr, ti); ct @ M^T -> (wr, wi); dM = psi^T ct
    err = wide_lane<2>(ysr, ysi, s.tr, s.ti, mr + l * ww, mi + l * ww, r, p.lw, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = wide_lane<1>(cr, ci, s.wr, s.wi, mr + l * ww, mi + l * ww, r, p.lw, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = wide_dm(s.tr, s.ti, cr, ci, s.part_dm, dm + l * ww,
                  static_cast<long>(L) * static_cast<long>(ww), r, p.lw, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    ml_row_bwd_kernel<<<p.grid_row, THREADS, p.bwd_smem, st>>>(
        s.tr, s.ti, s.wr, s.wi, s.sr, s.si, dsr, dsi, s.part_row,
        zzth + l * npairs, shifts, npairs, th + l * nrow, nrow, p.lw, p.ltl);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = colsum(s.part_row, p.grid_row, w, grads + l * w, w, 0, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
