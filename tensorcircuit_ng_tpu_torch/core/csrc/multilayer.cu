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
//    layer act on distinct bits and commute, so K10 takes the row bits in
//    another order than the JAX kernel (the sums differ by rounding).
//
// Design.  The TPU keeps the whole state (8 MB of planes at n = 20) resident
// in VMEM across the L grid steps; a CTA holds at most 227 KB.  So one C
// entry point launches stage kernels layer by layer on the caller's stream,
// and a layer's planes (32 MB at n = 20: y, ct, psi, w) stay in the 50 MB L2.
// Bound at n = 20, L = 4: operations.  Each lane product is 8 W flops an
// amplitude, 2.15 GFLOP a layer at W = 256 (32.05 us at 67 TFLOP/s float32
// outside the tensor cores; three a layer backward); the row stage moves
// 33.5 MB a layer (10 us at 3.35 TB/s).  Plain f32 FMAs, no fast-math.
//
//   products (wide_nt_kernel): c = a @ b^T on (rows, W) planes with b read
//     as b[n][k], so every operand is contiguous along the summed axis and
//     arrives by 16-byte cp.async in double-buffered chunks of 32 k (row
//     stride 36 floats: a quarter warp's float4 reads fall in distinct
//     banks).  A CTA owns a 64 x 64 output tile, a thread a 4 x 4
//     micro-tile (rows ty + 16a, columns tx + 16b), each complex
//     multiply-add two fmaf a plane.  K10's un-lane and ct walk are one
//     launch (NA = 2) sharing each chunk of M; K9's y = x @ M is the same
//     kernel (NA = 1) on M^T, transposed once a call.  Two CTAs an SM.
//   dM (wide_dm_kernel): dM = psi^T ct, contiguous along the outputs: 64 x
//     64 tiles split over row chunks (16 at n = 20: 256 CTAs; 8 chunks, 128
//     CTAs, measured slower), the same double-buffered copies, a thread
//     4 x 4 outputs; one partial a chunk, added by colsum_kernel in order.
//   row stage (ml_row_pass_kernel): the row bits in at most two passes of
//     at most 6 bits (the high ones, then the low ones with the zz stage).
//     A CTA owns a tile of 2^11 elements: 32 consecutive lanes (full 32-byte
//     sectors a warp) by the pass's rows, filled with more lanes or rows.
//     A thread holds 8 elements of all four planes in registers and runs
//     the butterflies of 3 bits there; for more bits the tile crosses
//     shared memory once and the thread takes 8 other elements.  A CTA owns
//     its tile, so a pass runs in place.  The zz exponent of the thread's 8
//     elements is E0 + sum_u A_u s_u + sum_uv B_uv s_u s_v over its 3
//     register bits (s = +-1), one sweep over the pairs, which
//     ml_pair_records_kernel sorts once a call by the register bits they
//     touch; dzz takes the 7 Walsh sums of h, transformed over the warp's 5
//     lane bits by shuffles, so a pair's warp sum is one shuffle.  dth and
//     dzz end as one partial a CTA (a warp tree, then the warps in order),
//     added by colsum_tree_kernel in a fixed order.
//   Scratch at n = 20: y, psi and w (24 MB), the dM partials (8 MB).
// Every sum across CTAs is a per-CTA partial added in a fixed order: no
// atomics, two runs agree bit for bit.  The TPU's "interleave sweep", the
// host-built sign matrices and the 128-column pair padding are layout
// devices of the TPU and are not carried over.

#include <initializer_list>

#include "lane.cuh"

namespace {

// K9's row tile: 2^nrow x TL complex elements (8192: 64 KB of two planes)
constexpr int ML_TILE = 8192;
constexpr int ML_MAX_NROW = 12;
constexpr int ML_MAX_PAIRS = 128;

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

// ---------------------------------------------------------------------------
// Lane products.
// ---------------------------------------------------------------------------

constexpr int P_T = 64;        // output tile edge
constexpr int P_KC = 32;       // k a chunk
constexpr int P_KS = P_KC + 4; // row stride of a chunk plane in smem
constexpr int P_PLANE = P_T * P_KS;

// Floats of one buffered chunk: the NA a operands' planes and b's.
template <int NA>
__host__ __device__ constexpr int prod_stage() { return (2 * NA + 2) * P_PLANE; }

template <int NA>
__host__ __device__ constexpr size_t prod_smem() { return sizeof(float) * 2 * prod_stage<NA>(); }

// c1 = a1 @ conj(b)^T (CONJ) or a1 @ b^T, and with NA = 2 also c2 = a2 @
// b^T: a_p and c_p (rows, W) planes, b (W, W) read as b[n][k].  No c may
// alias an a.  Every pointer is 16-byte aligned.
template <int NA, bool CONJ>
__global__ void __launch_bounds__(THREADS, 2)
wide_nt_kernel(const float* a1r, const float* a1i, const float* a2r,
               const float* a2i, const float* __restrict__ br,
               const float* __restrict__ bi, float* c1r, float* c1i,
               float* c2r, float* c2i, int rows, int lw) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NP = 2 * NA + 2;
  const long row0 = static_cast<long>(blockIdx.x) * P_T;
  const int col0 = blockIdx.y * P_T;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  // chunk at k0 into buffer s: planes a1 r/i, (a2 r/i), b r/i, row-major
  auto load = [&](int s, int k0) {
    float* buf = smem + s * prod_stage<NA>();
    for (int e = threadIdx.x; e < NP * P_T * (P_KC / 4); e += THREADS) {
      const int p = e / (P_T * (P_KC / 4)), row = (e / (P_KC / 4)) % P_T, q = e % (P_KC / 4);
      float* dst = buf + p * P_PLANE + row * P_KS + 4 * q;
      if (p < 2 * NA) {
        const float* src = p == 0 ? a1r : p == 1 ? a1i : p == 2 ? a2r : a2i;
        const long m = row0 + row;
        if (m < rows)
          cp_async16(dst, src + (m << lw) + k0 + 4 * q);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        const float* src = p == 2 * NA ? br : bi;
        cp_async16(dst, src + (static_cast<long>(col0 + row) << lw) + k0 + 4 * q);
      }
    }
  };
  float acc[NA][2][4][4];  // [product][re, im][row a][column b]
#pragma unroll
  for (int p = 0; p < NA; ++p)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[p][0][a][b] = acc[p][1][a][b] = 0.f;
  const int nch = (1 << lw) / P_KC;
  load(0, 0);
  cp_async_commit();
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) load((c + 1) & 1, (c + 1) * P_KC);
    cp_async_commit();
    cp_async_wait<1>();  // chunk c has landed (this thread's copies)
    __syncthreads();     // ... and every thread's
    const float* buf = smem + (c & 1) * prod_stage<NA>();
    const float* bs = buf + 2 * NA * P_PLANE;
#pragma unroll 1
    for (int k = 0; k < P_KC; k += 4) {
      float m_r[4][4], m_i[4][4];  // [column b][k]
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        vload<4>(bs + (tx + 16 * b) * P_KS + k, m_r[b]);
        vload<4>(bs + P_PLANE + (tx + 16 * b) * P_KS + k, m_i[b]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int p = 0; p < NA; ++p) {
          float x_r[4], x_i[4];
          vload<4>(buf + 2 * p * P_PLANE + (ty + 16 * a) * P_KS + k, x_r);
          vload<4>(buf + (2 * p + 1) * P_PLANE + (ty + 16 * a) * P_KS + k, x_i);
          const float sg = CONJ && p == 0 ? -1.f : 1.f;  // folds into the FFMA
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const float mr = m_r[b][kk], mi = sg * m_i[b][kk];
              acc[p][0][a][b] = fmaf(-x_i[kk], mi, fmaf(x_r[kk], mr, acc[p][0][a][b]));
              acc[p][1][a][b] = fmaf(x_i[kk], mr, fmaf(x_r[kk], mi, acc[p][1][a][b]));
            }
        }
      }
    }
    __syncthreads();  // the buffer is consumed before it is refilled
  }
#pragma unroll
  for (int p = 0; p < NA; ++p) {
    float* outr = p == 0 ? c1r : c2r;
    float* outi = p == 0 ? c1i : c2i;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const long m = row0 + ty + 16 * a;
      if (m >= rows) continue;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const long off = (m << lw) + col0 + tx + 16 * b;
        outr[off] = acc[p][0][a][b];
        outi[off] = acc[p][1][a][b];
      }
    }
  }
}

template <int NA, bool CONJ>
cudaError_t wide_nt(const float* a1r, const float* a1i, const float* a2r,
                    const float* a2i, const float* br, const float* bi,
                    float* c1r, float* c1i, float* c2r, float* c2i, int rows,
                    int lw, cudaStream_t st) {
  const dim3 grid((rows + P_T - 1) / P_T, (1 << lw) / P_T);
  wide_nt_kernel<NA, CONJ><<<grid, THREADS, prod_smem<NA>(), st>>>(
      a1r, a1i, a2r, a2i, br, bi, c1r, c1i, c2r, c2i, rows, lw);
  return cudaGetLastError();
}

// bt[l] = b[l]^T for the L (W, W) planes of b (32 x 32 tiles, blockDim (32, 8)).
__global__ void transpose_kernel(const float* b, float* bt, int lw) {
  __shared__ float t[32][33];
  const long base = static_cast<long>(blockIdx.z) << (2 * lw);
  const int x0 = blockIdx.x * 32, y0 = blockIdx.y * 32;
  for (int j = threadIdx.y; j < 32; j += 8)
    t[j][threadIdx.x] = b[base + (static_cast<long>(y0 + j) << lw) + x0 + threadIdx.x];
  __syncthreads();
  for (int j = threadIdx.y; j < 32; j += 8)
    bt[base + (static_cast<long>(x0 + j) << lw) + y0 + threadIdx.x] = t[threadIdx.x][j];
}

// dM: the 64 x 64 output tiles split over row chunks of D_KC-row stages.
constexpr int D_KC = 32;
constexpr size_t DM_SMEM = sizeof(float) * 2 * 4 * D_KC * P_T;

// Row chunks of the dM partials for (rows, W): about two CTAs an SM (256
// CTAs), at most DM_MAX_CHUNKS partials, at least one stage of rows each
// where there are that many (powers of two, so the chunks divide rows).
constexpr int DM_MAX_CHUNKS = 16;
int dm_chunks(int rows, int lw) {
  const int tiles = 1 << (2 * (lw - 6));
  int nc = 256 / tiles;
  if (nc > DM_MAX_CHUNKS) nc = DM_MAX_CHUNKS;
  if (nc > rows / D_KC) nc = rows / D_KC;
  return nc < 1 ? 1 : nc;
}

// part[blockIdx.y] (2, W, W) planes, tile blockIdx.x: the sum over the
// chunk's ch rows of p[row][a] * c[row][b], the non-conjugating p^T c.
__global__ void __launch_bounds__(THREADS, 2)
wide_dm_kernel(const float* pr, const float* pi, const float* cr,
               const float* ci, float* part, int ch, int lw) {
  extern __shared__ __align__(16) float smem[];
  constexpr int STAGE = 4 * D_KC * P_T;
  const int tiles_b = (1 << lw) / P_T;
  const int a0 = (blockIdx.x / tiles_b) * P_T, b0 = (blockIdx.x % tiles_b) * P_T;
  const long row0 = static_cast<long>(blockIdx.y) * ch;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  // stage s into buffer s & 1: planes p r/i (columns a0..), c r/i (b0..)
  auto load = [&](int s) {
    float* buf = smem + (s & 1) * STAGE;
    const int k0 = s * D_KC;
    for (int e = threadIdx.x; e < 4 * D_KC * (P_T / 4); e += THREADS) {
      const int p = e / (D_KC * (P_T / 4)), k = (e / (P_T / 4)) % D_KC, q = e % (P_T / 4);
      float* dst = buf + (p * D_KC + k) * P_T + 4 * q;
      const float* src = p == 0 ? pr : p == 1 ? pi : p == 2 ? cr : ci;
      if (k0 + k < ch)
        cp_async16(dst, src + ((row0 + k0 + k) << lw) + (p < 2 ? a0 : b0) + 4 * q);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  float acc_r[4][4], acc_i[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc_r[a][b] = acc_i[a][b] = 0.f;
  const int nst = (ch + D_KC - 1) / D_KC;
  load(0);
  cp_async_commit();
  for (int s = 0; s < nst; ++s) {
    if (s + 1 < nst) load(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* buf = smem + (s & 1) * STAGE;
#pragma unroll 4
    for (int k = 0; k < D_KC; ++k) {
      float p_r[4], p_i[4], c_r[4], c_i[4];
      vload<4>(buf + k * P_T + 4 * ty, p_r);
      vload<4>(buf + (D_KC + k) * P_T + 4 * ty, p_i);
      vload<4>(buf + (2 * D_KC + k) * P_T + 4 * tx, c_r);
      vload<4>(buf + (3 * D_KC + k) * P_T + 4 * tx, c_i);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          acc_r[a][b] = fmaf(-p_i[a], c_i[b], fmaf(p_r[a], c_r[b], acc_r[a][b]));
          acc_i[a][b] = fmaf(p_i[a], c_r[b], fmaf(p_r[a], c_i[b], acc_i[a][b]));
        }
    }
    __syncthreads();
  }
  const long ww = 1L << (2 * lw);
  float* out = part + static_cast<long>(blockIdx.y) * 2 * ww;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const long o = (static_cast<long>(a0 + 4 * ty + a) << lw) + b0 + 4 * tx;
    vstore<4>(out + o, acc_r[a]);
    vstore<4>(out + ww + o, acc_i[a]);
  }
}

// Floats of the dM partials for (rows, W).
size_t dm_floats(int rows, int lw) {
  return static_cast<size_t>(dm_chunks(rows, lw)) * 2 << (2 * lw);
}

// dm planes (dm_out, dm_out + dm_stride) <- p^T c over all rows, as
// per-chunk partials added in a fixed order; part holds dm_floats.
cudaError_t wide_dm(const float* pr, const float* pi, const float* cr,
                    const float* ci, float* part, float* dm_out, long dm_stride,
                    int rows, int lw, cudaStream_t st) {
  const int nc = dm_chunks(rows, lw);
  const int tiles = 1 << (2 * (lw - 6));
  wide_dm_kernel<<<dim3(tiles, nc), THREADS, DM_SMEM, st>>>(pr, pi, cr, ci, part, rows / nc, lw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long ww = 1L << (2 * lw);
  return colsum(part, nc, static_cast<int>(2 * ww), dm_out, static_cast<int>(ww), dm_stride, st);
}

// ---------------------------------------------------------------------------
// K10's row stage.
// ---------------------------------------------------------------------------

constexpr int RP_TB = 11;    // tile bits: 2^11 elements, 32 KB of four planes
constexpr int RP_MAXB = 6;   // row bits a pass
constexpr int RP_MAXC = 24;  // CTA bits

// One pass of the row stage.  Tile bits 0..4 are lanes 0..4, tile bits
// 5..5+nb-1 the pass's row bits, the rest more lanes, then other rows; the
// CTA index holds the remaining flat bits.
struct RowPass {
  int tb;              // tile bits (8..11)
  int nb;              // row bits of the pass (1..6): tile bits 5..
  int ncb;             // CTA bits
  int q[RP_MAXB];      // rx angle of the pass's row bit i
  int tmap[RP_TB];     // flat bit of tile bit i
  int cmap[RP_MAXC];   // flat bit of CTA bit i
};

// Flat offset of the tile bits of e (register or thread bits); flat
// indices have at most 22 bits.
__device__ __forceinline__ int tile_flat(int e, const RowPass& rp) {
  int f = 0;
#pragma unroll
  for (int i = 0; i < RP_TB; ++i)
    if (i < rp.tb) f |= ((e >> i) & 1) << rp.tmap[i];
  return f;
}

// The rx butterflies of pass bits i0..i0+2 on the thread's 8 elements,
// register bit j = pass bit i0 + j: un-apply [[c, -i s], [-i s, c]] from
// psi (z), the two dth sums into d[i0 + j] as -1/2 s S1 + 1/2 c S2, and
// the walk of ct (u) through the transpose.
template <int I0>
__device__ __forceinline__ void row_butterflies(float (&zr)[8], float (&zi)[8],
                                                float (&ur)[8], float (&ui)[8],
                                                float (&d)[RP_MAXB],
                                                const float* cs, int nb) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (I0 + j >= nb) continue;
    const float c = cs[2 * (I0 + j)], sn = cs[2 * (I0 + j) + 1];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int lo = 0; lo < 8; ++lo) {
      if (lo & (1 << j)) continue;
      const int hi = lo | (1 << j);
      const float ar = zr[lo], ai = zi[lo], br = zr[hi], bi = zi[hi];
      const float nar = fmaf(-sn, bi, c * ar), nai = fmaf(sn, br, c * ai);
      const float nbr = fmaf(-sn, ai, c * br), nbi = fmaf(sn, ar, c * bi);
      zr[lo] = nar, zi[lo] = nai, zr[hi] = nbr, zi[hi] = nbi;
      const float vr = ur[hi], vi = ui[hi], wr = ur[lo], wi = ui[lo];
      s1 = fmaf(wr, nar, s1), s1 = fmaf(-wi, nai, s1), s1 = fmaf(vr, nbr, s1), s1 = fmaf(-vi, nbi, s1);
      s2 = fmaf(vr, nai, s2), s2 = fmaf(vi, nar, s2), s2 = fmaf(wr, nbi, s2), s2 = fmaf(wi, nbr, s2);
      ur[lo] = fmaf(sn, vi, c * wr), ui[lo] = fmaf(-sn, vr, c * wi);
      ur[hi] = fmaf(sn, wi, c * vr), ui[hi] = fmaf(-sn, wr, c * vi);
    }
    d[I0 + j] += fmaf(-0.5f * sn, s1, 0.5f * c * s2);
  }
}

// a[i] for a runtime i, without a dynamic index into registers or the
// kernel's parameters (either would go through local memory)
template <typename T, int N>
__device__ __forceinline__ T pick(const T (&a)[N], int i) {
  T v = a[0];
#pragma unroll
  for (int j = 1; j < N; ++j) v = i == j ? a[j] : v;
  return v;
}

// x (-1)^popc(bits): x with its sign bit flipped by the parity of bits
__device__ __forceinline__ float signed_by(float x, int bits) {
  return __int_as_float(__float_as_int(x) ^ static_cast<int>((__popc(bits) & 1u) << 31));
}

// The pair records of the last row pass, one CTA (a warp) a layer: rec[l]
// holds (angle bits, fixed flat bits, pair index, 0) of every pair, sorted
// (stably) by its Walsh slot over the register flat bits v0, v1, v2 of the
// pass's final stage: slot 0 no register bit, 1 + u bit u alone, 4 + (u +
// v - 1) bits u < v; so[s] is the first record of slot s (so[7] = npairs).
__global__ void ml_pair_records_kernel(const float* __restrict__ zzth,
                                       const int* __restrict__ shifts, int npairs,
                                       int v0, int v1, int v2, int4* rec, int* so) {
  const int t = threadIdx.x;
  const float* zt = zzth + blockIdx.x * npairs;
  int4* out = rec + blockIdx.x * npairs;
  auto reg = [&](int b) { return b == v0 ? 0 : b == v1 ? 1 : b == v2 ? 2 : -1; };
  auto slot_of = [&](int k) {
    if (k >= npairs) return 7;
    const int ua = reg(shifts[2 * k]), ub = reg(shifts[2 * k + 1]);
    return ua < 0 && ub < 0 ? 0 : ua < 0 ? 1 + ub : ub < 0 ? 1 + ua : 3 + ua + ub;
  };
  int pos[8] = {0, 0, 0, 0, 0, 0, 0, 0};  // a counting sort by warp ballots
  for (int k0 = 0; k0 < npairs; k0 += 32) {
    const int sl = slot_of(k0 + t);
#pragma unroll
    for (int sv = 0; sv < 7; ++sv) pos[sv + 1] += __popc(__ballot_sync(0xffffffffu, sl == sv));
  }
#pragma unroll
  for (int sv = 0; sv < 7; ++sv) pos[sv + 1] += pos[sv];
  if (blockIdx.x == 0 && t < 8) so[t] = pick(pos, t);
  for (int k0 = 0; k0 < npairs; k0 += 32) {
    const int k = k0 + t, sl = slot_of(k);
#pragma unroll
    for (int sv = 0; sv < 7; ++sv) {
      const unsigned m = __ballot_sync(0xffffffffu, sl == sv);
      if (sl == sv) {
        const int sa = shifts[2 * k], sb = shifts[2 * k + 1];
        out[pos[sv] + __popc(m & ((1u << t) - 1))] = make_int4(
            __float_as_int(zt[k]), (reg(sa) < 0 ? 1 << sa : 0) | (reg(sb) < 0 ? 1 << sb : 0), k, 0);
      }
      pos[sv] += __popc(m);
    }
  }
}

// Shared bytes of a row pass: the exchange tile (nb > 3), LAST: a record
// a pair (its angle, fixed flat bits and index), the warp sums, cos/sin of
// the pass bits and the slots' offsets.
size_t row_pass_smem(const RowPass& rp, int npairs, bool last) {
  const int warps = (1 << (rp.tb - 3)) / 32;
  const size_t nel = size_t{1} << rp.tb;
  return sizeof(float) * ((rp.nb > 3 ? 4 * nel : 0) + warps * (RP_MAXB + npairs) + 2 * RP_MAXB + 8) +
         (last ? sizeof(int4) * npairs : 0);
}

// One pass of K10's row stage on the tile of CTA blockIdx.x: the rx bits of
// the pass on psi (tr, ti) and ct (wr, wi); not LAST: both written back in
// place; LAST: then the zz stage, x = conj(phase) z into (xr, xi) (skipped
// when xr is null) and ds = phase * ct into (dsr, dsi) (either may alias
// the planes it comes from).  Writes its dth (and LAST: every dzz) column
// of part[blockIdx.x] = (dzz[0..npairs), dth[0..nrow)).  LAST reads the
// layer's pair records grec and their slot offsets gso
// (ml_pair_records_kernel).  blockDim.x = 2^(tb-3), 8 elements a thread.
// Register caps: 64 (4 CTAs an SM) for the last pass; the first spills at
// 64, so 80 (3 CTAs an SM).
template <bool LAST>
__global__ void __launch_bounds__(THREADS, LAST ? 4 : 3)
ml_row_pass_kernel(float* tr, float* ti, float* wr, float* wi, float* xr,
                   float* xi, float* dsr, float* dsi, float* part,
                   const int4* __restrict__ grec, const int* __restrict__ gso,
                   int npairs, const float* __restrict__ th, int nrow, RowPass rp) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int nel = 1 << rp.tb, warps = blockDim.x >> 5;
  float* xs = smem;
  // LAST: the layer's pair records (ml_pair_records_kernel) and the slots'
  // offsets: slot s holds records [so[s], so[s + 1])
  int4* rec = reinterpret_cast<int4*>(xs + (rp.nb > 3 ? 4 * nel : 0));
  float* red = reinterpret_cast<float*>(rec + (LAST ? npairs : 0));  // [warp][dth, dzz]
  const int nred = RP_MAXB + npairs;
  float* cs = red + warps * nred;
  int* so = reinterpret_cast<int*>(cs + 2 * RP_MAXB);
  if (t < rp.nb) sincosf(0.5f * th[pick(rp.q, t)], &cs[2 * t + 1], &cs[2 * t]);
  if (LAST) {
    for (int k = t; k < npairs; k += blockDim.x) rec[k] = grec[k];
    if (t < 8) so[t] = gso[t];
  }
  int cbase = 0;
#pragma unroll
  for (int i = 0; i < RP_MAXC; ++i)
    if (i < rp.ncb) cbase |= ((blockIdx.x >> i) & 1) << rp.cmap[i];
  __syncthreads();

  // stage 1: tile bits 5..7 in registers, the thread on tile bits 0..4, 8..
  float zr[8], zi[8], ur[8], ui[8], d[RP_MAXB];
#pragma unroll
  for (int i = 0; i < RP_MAXB; ++i) d[i] = 0.f;
  const int e1 = (t & 31) | ((t >> 5) << 8);
  int f = cbase + tile_flat(e1, rp);
  int dl[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    dl[r] = 0;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (r & (1 << j)) dl[r] |= 1 << rp.tmap[5 + j];
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    zr[r] = tr[f + dl[r]];
    zi[r] = ti[f + dl[r]];
    ur[r] = wr[f + dl[r]];
    ui[r] = wi[f + dl[r]];
  }
  row_butterflies<0>(zr, zi, ur, ui, d, cs, rp.nb);
  if (rp.nb > 3) {
    // stage 2: across shared memory to tile bits 8..10 in registers
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int e = e1 | (r << 5);
      xs[e] = zr[r], xs[nel + e] = zi[r], xs[2 * nel + e] = ur[r], xs[3 * nel + e] = ui[r];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int e = t | (r << 8);
      zr[r] = xs[e], zi[r] = xs[nel + e], ur[r] = xs[2 * nel + e], ui[r] = xs[3 * nel + e];
    }
    f = cbase + tile_flat(t, rp);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      dl[r] = 0;
#pragma unroll
      for (int j = 0; j < 3; ++j)
        if (r & (1 << j)) dl[r] |= 1 << rp.tmap[8 + j];
    }
    row_butterflies<3>(zr, zi, ur, ui, d, cs, rp.nb);
  }
  const int lane = t & 31, warp = t >> 5;
  if (!LAST) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      tr[f + dl[r]] = zr[r];
      ti[f + dl[r]] = zi[r];
      wr[f + dl[r]] = ur[r];
      wi[f + dl[r]] = ui[r];
    }
  } else {
    // zz: the exponent's 7 Walsh coefficients over the 3 register bits
    float co[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int sv = 0; sv < 7; ++sv)
      for (int k = so[sv]; k < so[sv + 1]; ++k) {
        // the angle times the signs of the pair's fixed bits
        const int4 q = rec[k];
        co[sv] += signed_by(__int_as_float(q.x), f & q.y);
      }
    float hw[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // Walsh sums of h
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      // s_u = +1 where register bit u of r is 0; slots 4, 5, 6 = bits (0,1), (0,2), (1,2)
      const float s0 = r & 1 ? -1.f : 1.f, s1 = r & 2 ? -1.f : 1.f, s2 = r & 4 ? -1.f : 1.f;
      const float sg[7] = {1.f, s0, s1, s2, s0 * s1, s0 * s2, s1 * s2};
      float expo = 0.f;
#pragma unroll
      for (int i = 0; i < 7; ++i) expo = fmaf(sg[i], co[i], expo);
      // the phase angle expo / 2 in units of pi: sincospif reduces its
      // argument exactly (sincosf's slow path would need a local frame)
      float sn, c;
      sincospif(expo * (0.5f / 3.14159265358979f), &sn, &c);
      const float u_r = ur[r], u_i = ui[r], z_r = zr[r], z_i = zi[r];
      const float h = fmaf(u_r, z_i, u_i * z_r);
#pragma unroll
      for (int i = 0; i < 7; ++i) hw[i] = fmaf(sg[i], h, hw[i]);
      const int off = f + dl[r];
      dsr[off] = fmaf(sn, u_i, c * u_r);
      dsi[off] = fmaf(-sn, u_r, c * u_i);
      if (xr) {
        xr[off] = fmaf(-sn, z_i, c * z_r);
        xi[off] = fmaf(sn, z_r, c * z_i);
      }
    }
    // dzz: the Walsh-Hadamard transform of each hw over the warp's lanes
    // (flat bits 0..4): lane L holds sum over lanes l of hw(l) (-1)^|l & L|
#pragma unroll
    for (int i = 0; i < 7; ++i)
#pragma unroll
      for (int b = 0; b < 5; ++b) {
        const float o = __shfl_xor_sync(0xffffffffu, hw[i], 1 << b);
        hw[i] = lane & (1 << b) ? o - hw[i] : hw[i] + o;
      }
    // a pair's warp sum: its slot's transform at the lane of its fixed lane
    // bits, times the sign of its other fixed bits (the same in the warp)
#pragma unroll
    for (int sv = 0; sv < 7; ++sv)
      for (int k = so[sv]; k < so[sv + 1]; ++k) {
        const int4 q = rec[k];
        const float v = __shfl_sync(0xffffffffu, hw[sv], q.y & 31);
        if (lane == 0) red[warp * nred + RP_MAXB + q.z] = signed_by(0.5f * v, f & q.y & ~31);
      }
  }
#pragma unroll
  for (int i = 0; i < RP_MAXB; ++i) {
    if (i >= rp.nb) break;
    const float v = warp_sum(d[i]);
    if (lane == 0) red[warp * nred + i] = v;
  }
  __syncthreads();
  // the warps' sums in order: dth of the pass bits, then (LAST) dzz
  float* mypart = part + static_cast<long>(blockIdx.x) * (npairs + nrow);
  const int nout = LAST ? RP_MAXB + npairs : rp.nb;
  for (int k = t; k < nout; k += blockDim.x) {
    if (k >= rp.nb && k < RP_MAXB) continue;
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += red[w * nred + k];
    mypart[k < RP_MAXB ? npairs + pick(rp.q, k) : k - RP_MAXB] = s;
  }
}

// out[j] = sum over b < nb, in a fixed order, of part[b * ncols + j]: one
// CTA a column (for many partials of few columns).
__global__ void __launch_bounds__(THREADS)
colsum_tree_kernel(const float* part, int nb, int ncols, float* out) {
  __shared__ float red[NWARPS];
  const int j = blockIdx.x;
  float s = 0.f;
  for (int b = threadIdx.x; b < nb; b += THREADS) s += part[static_cast<long>(b) * ncols + j];
  s = block_sum(s, red);
  if (threadIdx.x == 0) out[j] = s;
}

// ---------------------------------------------------------------------------
// Plans and entry points.
// ---------------------------------------------------------------------------

struct MlPlan {
  int r, lw;
  int ltl, grid_row;   // K9's row stage: 2^ltl lanes a CTA, grid_row CTAs
  size_t fwd_smem;     // ... and its shared bytes
  int npass;           // K10's row passes: pass[0] the high row bits when
  RowPass pass[2];     // there are two, pass[npass - 1] the low ones and zz
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
  p->npass = nrow > RP_MAXB ? 2 : 1;
  const int total = nrow + lw;
  for (int k = 0; k < p->npass; ++k) {
    const bool last = k == p->npass - 1;
    const int lo = last ? 0 : RP_MAXB;  // row bits [lo, hi) from the lowest
    const int hi = last ? (nrow < RP_MAXB ? nrow : RP_MAXB) : nrow;
    RowPass& rp = p->pass[k];
    rp = RowPass{};
    rp.nb = hi - lo;
    rp.tb = total < RP_TB ? total : RP_TB;
    bool used[32] = {};
    int n = 0;
    for (int i = 0; i < 5; ++i) used[rp.tmap[n++] = i] = true;
    for (int i = 0; i < rp.nb; ++i) {
      used[rp.tmap[n++] = lw + lo + i] = true;
      rp.q[i] = nrow - 1 - (lo + i);
    }
    for (int b = 5; b < total && n < rp.tb; ++b)
      if (!used[b]) used[rp.tmap[n++] = b] = true;
    for (int b = 0; b < total; ++b)
      if (!used[b]) rp.cmap[rp.ncb++] = b;
  }
  return true;
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct MlScratch {
  float *tr, *ti, *mtr, *mti;                          // K9
  float *yr, *yi, *pr, *pi, *wr, *wi, *part_row, *part_dm, *rec;  // K10
};

// Floats of scratch (bwd = 0: K9, 1: K10), each part a multiple of 64
// floats (16-byte aligned); fills s when base is given.
size_t ml_layout(const MlPlan& p, int npairs, int nrow, int L, bool bwd,
                 float* base, MlScratch* s) {
  const size_t plane = static_cast<size_t>(p.r) << p.lw;
  const size_t mats = static_cast<size_t>(L) << (2 * p.lw);
  const size_t rows = static_cast<size_t>(1) << p.pass[0].ncb;
  size_t sizes[13] = {
      bwd ? 0 : plane, bwd ? 0 : plane, bwd ? 0 : mats, bwd ? 0 : mats,
      bwd ? plane : 0, bwd ? plane : 0, bwd ? plane : 0, bwd ? plane : 0,
      bwd ? plane : 0, bwd ? plane : 0,
      bwd ? rows * (npairs + nrow) : 0,
      bwd ? dm_floats(p.r, p.lw) : 0,
      bwd ? 4 * static_cast<size_t>(L) * npairs + 8 : 0,  // pair records, slot offsets
  };
  float* ptrs[13];
  size_t off = 0;
  for (int i = 0; i < 13; ++i) {
    ptrs[i] = base ? base + off : nullptr;
    off += (sizes[i] + 63) / 64 * 64;
  }
  if (s)
    *s = MlScratch{ptrs[0], ptrs[1], ptrs[2], ptrs[3], ptrs[4], ptrs[5],
                   ptrs[6], ptrs[7], ptrs[8], ptrs[9], ptrs[10], ptrs[11], ptrs[12]};
  return off;
}

bool all_aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* q : ptrs)
    if (!aligned16(q)) return false;
  return true;
}

// out[0..8): CTAs, threads, shared bytes, CTAs an SM, registers, local
// bytes a thread, x1, x2 of a kernel; sets its shared-memory limit.
cudaError_t kernel_record(const void* kern, long ctas, int threads, size_t smem,
                          long x1, long x2, long* out) {
  cudaError_t err = set_smem(kern, smem);
  int occ = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, threads, smem);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kern);
  if (err != cudaSuccess) return err;
  const long vals[8] = {ctas, threads, static_cast<long>(smem), occ, fa.numRegs,
                        static_cast<long>(fa.localSizeBytes), x1, x2};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return cudaSuccess;
}

const void* row_pass_fn(bool last) {
  return last ? reinterpret_cast<const void*>(ml_row_pass_kernel<true>)
              : reinterpret_cast<const void*>(ml_row_pass_kernel<false>);
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
  return static_cast<long>(ml_layout(p, npairs, nrow, L, bwd != 0, nullptr, nullptr));
}

// The stage kernels' plan at these shapes, for the record: five records of
// 8 (kernel_record): K10's product pair (x1, x2 = the tile's rows and
// columns), K9's product (the same), K10's dM (x1 = chunks, x2 = rows a
// chunk), K10's first row pass and its last (x1 = tile elements, x2 = the
// pass's row bits; the first has 0 CTAs when there is one pass).
int tcng_ml_plan(int r, int lanes, int nrow, int npairs, long* out) {
  MlPlan p;
  if (!ml_plan(r, lanes, nrow, npairs, &p)) return static_cast<int>(cudaErrorInvalidValue);
  const long prod_ctas = static_cast<long>((r + P_T - 1) / P_T) * (lanes / P_T);
  const int nc = dm_chunks(r, p.lw);
  cudaError_t err = kernel_record(reinterpret_cast<const void*>(wide_nt_kernel<2, true>), prod_ctas,
                                  THREADS, prod_smem<2>(), P_T, P_T, out);
  if (err == cudaSuccess)
    err = kernel_record(reinterpret_cast<const void*>(wide_nt_kernel<1, false>), prod_ctas, THREADS,
                        prod_smem<1>(), P_T, P_T, out + 8);
  if (err == cudaSuccess)
    err = kernel_record(reinterpret_cast<const void*>(wide_dm_kernel), static_cast<long>(nc) << (2 * (p.lw - 6)),
                        THREADS, DM_SMEM, nc, r / nc, out + 16);
  for (int k = 0; k < 2 && err == cudaSuccess; ++k) {
    const bool last = k == 1;
    const RowPass& rp = p.pass[last ? p.npass - 1 : 0];
    const bool runs = last || p.npass == 2;
    err = kernel_record(row_pass_fn(last), runs ? 1L << rp.ncb : 0, 1 << (rp.tb - 3),
                        row_pass_smem(rp, npairs, last), 1L << rp.tb, runs ? rp.nb : 0, out + 24 + 8 * k);
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
  ml_layout(p, npairs, nrow, L, false, scratch, &s);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(ml_row_fwd_kernel), p.fwd_smem);
  if (err == cudaSuccess)
    err = set_smem(reinterpret_cast<const void*>(wide_nt_kernel<1, false>), prod_smem<1>());
  if (err != cudaSuccess) return static_cast<int>(err);
  // M^T once a call: the product reads its b operand as b[n][k]
  const dim3 tgrid(lanes / 32, lanes / 32, L);
  transpose_kernel<<<tgrid, dim3(32, 8), 0, st>>>(mr, s.mtr, p.lw);
  transpose_kernel<<<tgrid, dim3(32, 8), 0, st>>>(mi, s.mti, p.lw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t ww = static_cast<size_t>(lanes) * lanes;
  for (int l = 0; l < L; ++l) {
    ml_row_fwd_kernel<<<p.grid_row, THREADS, p.fwd_smem, st>>>(
        l == 0 ? sr : yr, l == 0 ? si : yi, s.tr, s.ti, zzth + l * npairs,
        shifts, npairs, th + l * nrow, nrow, p.lw, p.ltl);
    err = cudaGetLastError();
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
  ml_layout(p, npairs, nrow, L, true, scratch, &s);
  const RowPass& last = p.pass[p.npass - 1];
  const size_t smem_a = row_pass_smem(p.pass[0], npairs, false);
  const size_t smem_b = row_pass_smem(last, npairs, true);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(wide_nt_kernel<2, true>), prod_smem<2>());
  if (err == cudaSuccess) err = set_smem(reinterpret_cast<const void*>(wide_dm_kernel), DM_SMEM);
  if (err == cudaSuccess) err = set_smem(row_pass_fn(false), smem_a);
  if (err == cudaSuccess) err = set_smem(row_pass_fn(true), smem_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t ww = static_cast<size_t>(lanes) * lanes;
  const int w = npairs + nrow;
  const int grid_row = 1 << last.ncb, threads = 1 << (last.tb - 3);
  // every layer's pair records for the zz stage, once a call
  int4* rec = reinterpret_cast<int4*>(s.rec);
  int* so = reinterpret_cast<int*>(s.rec + 4 * static_cast<size_t>(L) * npairs);
  const int rb = last.nb > 3 ? 8 : 5;  // the final stage's register tile bits
  ml_pair_records_kernel<<<L, 32, 0, st>>>(zzth, shifts, npairs, last.tmap[rb], last.tmap[rb + 1],
                                           last.tmap[rb + 2], rec, so);
  for (int l = L - 1; l >= 0; --l) {
    const float* ysr = l == L - 1 ? yr : s.yr;
    const float* ysi = l == L - 1 ? yi : s.yi;
    const float* cr = l == L - 1 ? ctr : dsr;
    const float* ci = l == L - 1 ? cti : dsi;
    // psi = y @ conj(M)^T -> (pr, pi) and ct @ M^T -> (wr, wi); dM = psi^T ct
    err = wide_nt<2, true>(ysr, ysi, cr, ci, mr + l * ww, mi + l * ww, s.pr, s.pi, s.wr, s.wi, r,
                           p.lw, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = wide_dm(s.pr, s.pi, cr, ci, s.part_dm, dm + l * ww, static_cast<long>(L * ww), r, p.lw, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    // the row stage: the high row bits in place, then the low ones with zz
    // (x into y's scratch for the next layer, none after layer 0)
    if (p.npass == 2)
      ml_row_pass_kernel<false><<<grid_row, threads, smem_a, st>>>(
          s.pr, s.pi, s.wr, s.wi, nullptr, nullptr, nullptr, nullptr, s.part_row,
          nullptr, nullptr, npairs, th + l * nrow, nrow, p.pass[0]);
    ml_row_pass_kernel<true><<<grid_row, threads, smem_b, st>>>(
        s.pr, s.pi, s.wr, s.wi, l ? s.yr : nullptr, l ? s.yi : nullptr, dsr, dsi, s.part_row,
        rec + l * npairs, so, npairs, th + l * nrow, nrow, last);
    colsum_tree_kernel<<<w, THREADS, 0, st>>>(s.part_row, grid_row, w, grads + l * w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
