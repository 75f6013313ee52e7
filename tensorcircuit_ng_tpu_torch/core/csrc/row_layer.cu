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
//    gate in reverse: un-apply g^dagger, the four complex sums of dg, walk
//    ct by g^T.  Returns ds = ct, dg (2, nkernel, 4) and dM.
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
// (nkernel = 11), nine times a CTA's 227 KB of shared memory.  The row
// butterflies never mix lanes, so a CTA takes all RB rows of one block for
// TL = 8192 / RB lanes (TL = 4 at nkernel = 11): a tile of 8192 complex
// elements, 64 KB for the forward's two planes and 128 KB for the
// backward's four (state and cotangent).  The grid is (r / RB) x (128 / TL)
// CTAs, 128 at n = 20.  Every butterfly stage runs in place in shared
// memory with one barrier between gates.  The lane matmul needs whole rows,
// so it is a second pass over the state (lane.cuh), which at n = 20 (8 MB
// of planes) stays in the 50 MB L2.  K7's dg sums are written as one
// partial a CTA (a warp shuffle tree, then the warps in order) and added by
// colsum_kernel in a fixed order: no atomics, so K7 is bit-identical run to
// run.  K8 is K6's row pass walking the transposed gates in reverse.
// Bounds at n = 20, nkernel = 11, on the H100 (3.35 TB/s, 67 TFLOP/s
// float32): K6 without the lane moves 16.8 MB (two planes in, two out) for
// 0.16 GFLOP, 0.005 ms, bound by bytes; with the lane the 1.07 GFLOP of
// lane products bound it by operations (0.018 ms); K7 without the lane
// moves 25 MB for 0.5 GFLOP (0.0076 ms, bytes); K8 as K6 (0.005 ms).
// K11 and K12 use K6's and K7's tiles: at n = 20, nkernel = 10 (r = 8192),
// K11 moves 16.8 MB (0.005 ms, bytes) and K12 25 MB (0.0075 ms, bytes);
// K12's dth sums are block sums into one partial a CTA, added by
// colsum_kernel in a fixed order, as K7's dg.
// Launch latency alone is a few microseconds, so these simple kernels sit
// well above their bounds; the design keeps the state to one read and one
// write a pass.  Plain f32 FMAs, no fast-math.

#include "lane.cuh"

namespace {

// row tile: RB * TL complex elements (8192: 64 KB of two planes)
constexpr int TILE_ELEMS = 8192;
// RB <= 2048 = TILE_ELEMS / 4 keeps at least 4 lanes a tile
constexpr int MAX_NKERNEL = 11;

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

// K7's row pass on an RB x TL tile of psi (pre-lane state) and ct: writes
// ds and one partial a CTA, part[blk] = (re of dg (nkernel, 4), im of dg).
__global__ void __launch_bounds__(THREADS)
row_bwd_kernel(const float* psr, const float* psi, const float* ctr,
               const float* cti, float* dsr, float* dsi, float* part,
               const float* __restrict__ gr, const float* __restrict__ gi,
               int nkernel, int ltl) {
  extern __shared__ float smem[];
  const int rb = 1 << nkernel;
  const int elems = rb << ltl;
  float* tr = smem;
  float* ti = tr + elems;
  float* cr = ti + elems;
  float* ci = cr + elems;
  float* g = ci + elems;
  // two buffers of the warp sums: a warp writes the next gate's sums only
  // after the barrier that warp 0 reaches once it has read this gate's
  float* red = g + 8 * nkernel;
  load_gates(g, gr, gi, nkernel);
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const long off = tile_off(e, ltl, rb);
    tr[e] = psr[off];
    ti[e] = psi[off];
    cr[e] = ctr[off];
    ci[e] = cti[off];
  }
  __syncthreads();
  float* mypart = part + static_cast<long>(blockIdx.x) * 8 * nkernel;
  const int half = elems >> 1;
  const int warp = threadIdx.x >> 5;
  for (int q = nkernel - 1; q >= 0; --q) {
    const int ls = nkernel - 1 - q;
    const float* m = g + 8 * q;
    const float g00r = m[0], g00i = m[1], g01r = m[2], g01i = m[3];
    const float g10r = m[4], g10i = m[5], g11r = m[6], g11i = m[7];
    // dg entries (00, 01, 10, 11), (re, im) interleaved
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int p = threadIdx.x; p < half; p += blockDim.x) {
      int elo, ehi;
      pair_elems(p, ls, ltl, &elo, &ehi);
      // 1) un-apply: s <- g^dagger s, g^dagger = [[g00*, g10*], [g01*, g11*]]
      const float ar = tr[elo], ai = ti[elo], br = tr[ehi], bi = ti[ehi];
      const float lr = g00r * ar + g00i * ai + g10r * br + g10i * bi;
      const float li = g00r * ai - g00i * ar + g10r * bi - g10i * br;
      const float hr = g01r * ar + g01i * ai + g11r * br + g11i * bi;
      const float hi = g01r * ai - g01i * ar + g11r * bi - g11i * br;
      tr[elo] = lr;
      ti[elo] = li;
      tr[ehi] = hr;
      ti[ehi] = hi;
      // 2) dg[a][b] += ct[bit a] * s[bit b]
      const float xr = cr[elo], xi = ci[elo], zr = cr[ehi], zi = ci[ehi];
      acc[0] += xr * lr - xi * li;
      acc[1] += xr * li + xi * lr;
      acc[2] += xr * hr - xi * hi;
      acc[3] += xr * hi + xi * hr;
      acc[4] += zr * lr - zi * li;
      acc[5] += zr * li + zi * lr;
      acc[6] += zr * hr - zi * hi;
      acc[7] += zr * hi + zi * hr;
      // 3) walk: ct <- g^T ct, g^T = [[g00, g10], [g01, g11]]
      cr[elo] = g00r * xr - g00i * xi + g10r * zr - g10i * zi;
      ci[elo] = g00r * xi + g00i * xr + g10r * zi + g10i * zr;
      cr[ehi] = g01r * xr - g01i * xi + g11r * zr - g11i * zi;
      ci[ehi] = g01r * xi + g01i * xr + g11r * zi + g11i * zr;
    }
    float* rb_q = red + (q & 1) * 8 * NWARPS;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float v = acc[k];
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if ((threadIdx.x & 31) == 0) rb_q[warp * 8 + k] = v;
    }
    __syncthreads();  // also the barrier between gates
    if (threadIdx.x < 8) {
      float t = 0.f;
      for (int w = 0; w < NWARPS; ++w) t += rb_q[w * 8 + threadIdx.x];
      mypart[(threadIdx.x & 1) * 4 * nkernel + 4 * q + (threadIdx.x >> 1)] = t;
    }
  }
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const long off = tile_off(e, ltl, rb);
    dsr[off] = cr[e];
    dsi[off] = ci[e];
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

// K12's row pass on an RB x TL tile of y and ct: writes ds and one partial
// a CTA, part[blk] = dth[0..nkernel).
__global__ void __launch_bounds__(THREADS)
rotx_bwd_kernel(const float* yr, const float* yi, const float* ctr,
                const float* cti, float* dsr, float* dsi, float* part,
                const float* __restrict__ th, int nkernel, int ltl) {
  extern __shared__ float smem[];
  const int rb = 1 << nkernel;
  const int elems = rb << ltl;
  float* tr = smem;
  float* ti = tr + elems;
  float* cr = ti + elems;
  float* ci = cr + elems;
  float* cs = ci + elems;
  float* red = cs + 2 * nkernel;
  for (int q = threadIdx.x; q < nkernel; q += blockDim.x)
    sincosf(0.5f * th[q], &cs[2 * q + 1], &cs[2 * q]);
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const long off = tile_off(e, ltl, rb);
    tr[e] = yr[off];
    ti[e] = yi[off];
    cr[e] = ctr[off];
    ci[e] = cti[off];
  }
  __syncthreads();
  float* mypart = part + static_cast<long>(blockIdx.x) * nkernel;
  const int half = elems >> 1;
  for (int q = nkernel - 1; q >= 0; --q) {
    const int ls = nkernel - 1 - q;
    const float c = cs[2 * q], sn = cs[2 * q + 1];
    float s1 = 0.f, s2 = 0.f;
    for (int p = threadIdx.x; p < half; p += blockDim.x) {
      int elo, ehi;
      pair_elems(p, ls, ltl, &elo, &ehi);
      // un-apply rx^dagger = [[c, +i s], [+i s, c]]
      const float ar = tr[elo], ai = ti[elo], br = tr[ehi], bi = ti[ehi];
      const float nar = c * ar - sn * bi, nai = c * ai + sn * br;
      const float nbr = c * br - sn * ai, nbi = c * bi + sn * ar;
      tr[elo] = nar;
      ti[elo] = nai;
      tr[ehi] = nbr;
      ti[ehi] = nbi;
      // Re S1 = sum ct.psi, Im S2 = sum pct.psi over both rows of the pair
      const float ur = cr[elo], ui = ci[elo], vr = cr[ehi], vi = ci[ehi];
      s1 += ur * nar - ui * nai + vr * nbr - vi * nbi;
      s2 += vr * nai + vi * nar + ur * nbi + ui * nbr;
      // walk: ct <- c ct - i s pct
      cr[elo] = c * ur + sn * vi;
      ci[elo] = c * ui - sn * vr;
      cr[ehi] = c * vr + sn * ui;
      ci[ehi] = c * vi - sn * ur;
    }
    // the block sums are also the barrier between stages
    s1 = block_sum(s1, red);
    s2 = block_sum(s2, red);
    if (threadIdx.x == 0) mypart[q] = -0.5f * sn * s1 + 0.5f * c * s2;
  }
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const long off = tile_off(e, ltl, rb);
    dsr[off] = cr[e];
    dsi[off] = ci[e];
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

struct BwdScratch {
  float *part_row, *part_dm, *pr, *pi, *wr, *wi;
};

// Floats of K7's scratch; fills s when base is given.
size_t bwd_layout(int r, const RowPlan& p, int nkernel, bool lane, float* base,
                  BwdScratch* s) {
  const size_t plane = static_cast<size_t>(r) * LANES;
  const size_t sizes[6] = {
      static_cast<size_t>(p.grid) * 8 * nkernel,
      lane ? dm_partial_floats(r) : 0,
      lane ? plane : 0, lane ? plane : 0, lane ? plane : 0, lane ? plane : 0,
  };
  float* ptrs[6];
  size_t off = 0;
  for (int i = 0; i < 6; ++i) {
    ptrs[i] = base ? base + off : nullptr;
    off += sizes[i];
  }
  if (s) *s = BwdScratch{ptrs[0], ptrs[1], ptrs[2], ptrs[3], ptrs[4], ptrs[5]};
  return off;
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
  RowPlan p;
  if (!row_plan(r, nkernel, &p)) return -1;
  return static_cast<long>(bwd_layout(r, p, nkernel, lane != 0, nullptr, nullptr));
}

// K7.  yr/yi: the layer's (r, 128) output planes (post-lane when mr is
// given); ctr/cti: cotangent planes; dsr/dsi: (r, 128) output; dg:
// (2, nkernel, 4) = (re, im) of the gate cotangent; dm: (2, 128, 128) =
// (dmr, dmi) or null without the lane; gr/gi (nkernel, 4); mr/mi (128, 128)
// unitary lane planes or null; scratch of tcng_row_bwd_scratch floats.
int tcng_row_bwd(const float* yr, const float* yi, const float* ctr,
                 const float* cti, float* dsr, float* dsi, float* dg,
                 float* dm, const float* gr, const float* gi, int nkernel,
                 const float* mr, const float* mi, float* scratch, int r,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RowPlan p;
  if (!row_plan(r, nkernel, &p)) return static_cast<int>(cudaErrorInvalidValue);
  BwdScratch s;
  bwd_layout(r, p, nkernel, mr != nullptr, scratch, &s);
  const float *psr = yr, *psi = yi, *cr = ctr, *ci = cti;
  if (mr != nullptr) {
    cudaError_t err = lane_bwd_stage(r, yr, yi, ctr, cti, mr, mi, s.pr, s.pi,
                                     s.wr, s.wi, s.part_dm, dm, MM, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    psr = s.pr;
    psi = s.pi;
    cr = s.wr;
    ci = s.wi;
  }
  const size_t smem = row_smem(4, nkernel, 2 * 8 * NWARPS);
  cudaError_t err = cudaFuncSetAttribute(
      row_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  row_bwd_kernel<<<p.grid, THREADS, smem, st>>>(psr, psi, cr, ci, dsr, dsi,
                                                s.part_row, gr, gi, nkernel,
                                                p.ltl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      colsum(s.part_row, p.grid, 8 * nkernel, dg, 8 * nkernel, 0, st));
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
  RowPlan p;
  if (!row_plan(r, nkernel, &p)) return -1;
  return static_cast<long>(p.grid) * nkernel;
}

// K12.  yr/yi: the layer's (r, 128) output planes; ctr/cti: cotangent
// planes; dsr/dsi (r, 128) output; dth (nkernel) output; th (nkernel);
// scratch of tcng_rotx_bwd_scratch floats.
int tcng_rotx_bwd(const float* yr, const float* yi, const float* ctr,
                  const float* cti, float* dsr, float* dsi, float* dth,
                  const float* th, int nkernel, float* scratch, int r,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RowPlan p;
  if (!row_plan(r, nkernel, &p)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = row_smem(4, 0, 2 * nkernel + NWARPS);
  cudaError_t err = cudaFuncSetAttribute(
      rotx_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rotx_bwd_kernel<<<p.grid, THREADS, smem, st>>>(yr, yi, ctr, cti, dsr, dsi, scratch, th,
                                                 nkernel, p.ltl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(colsum(scratch, p.grid, nkernel, dth, nkernel, 0, st));
}

}  // extern "C"
