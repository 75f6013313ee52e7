// Stage kernels of the adjoint of a zz + rx + lane layer for Hopper
// (sm_90a), on the (r, W) float32 plane pair of a complex64 statevector,
// W = 2^lw lanes, 128 <= W <= 1024.  Layout index = row * W + lane; qubit
// q is bit n-1-q of the flat index.  One set of kernels serves every
// adjoint of the port with these stages: K3 and K4 (zzrx_bwd.cu, W = 128),
// K7 (row_layer.cu, W = 128: the lane stage, and the row stage with
// general gates), K10 (multilayer.cu, W = 128-1024) and K12 (row_layer.cu:
// the rx passes without the zz stage); the forwards K2 (zzrx_fwd.cu), K9
// (multilayer.cu), K6 and K11 (row_layer.cu) run on the same row-stage
// plan, and so do K1 (zzrx_fwd.cu), K8 (row_layer.cu) and K15
// (micro_grand.cu, K6's passes); the product of K1, K2, K9, K15 and K6 with
// the lane is the same kernel with NA = 1, on M^T (transpose_kernel); K2
// and K15 share one outer pass (outer_fwd_kernel).
//
// Conventions (those of the JAX package): cotangent planes are (dL/dyr,
// -dL/dyi), the non-conjugating complex cotangent, and walk by the
// TRANSPOSE of each map; the lane-matrix cotangent planes are (dL/dmr,
// -dL/dmi).  Lane matrices and gates are unitary, so the adjoint rebuilds
// a state by un-application.
//
// The lane stage (adjoint_lane_stage) of an adjoint from the layer output
// y and the cotangent ct: psi = y @ conj(M)^T; dM = psi^T ct; ct <- ct @ M^T.
//   products (wide_nt_kernel): c = a @ b^T on (rows, W) planes with b read
//     as b[n][k], so every operand is contiguous along the summed axis and
//     arrives by 16-byte cp.async in double-buffered chunks of 32 k (row
//     stride 36 floats: a quarter warp's float4 reads fall in distinct
//     banks).  A CTA owns a 64 x 64 output tile, a thread a 4 x 4
//     micro-tile (rows ty + 16a, columns tx + 16b), each complex
//     multiply-add two fmaf a plane.  The un-lane and the ct walk are one
//     launch (NA = 2) sharing each chunk of M.  Two CTAs an SM.
//   dM (wide_dm_kernel): dM = psi^T ct, contiguous along the outputs: 64 x
//     64 tiles split over row chunks (dm_chunks: about 256 CTAs), the same
//     double-buffered copies, a thread 4 x 4 outputs; one partial a chunk,
//     added by colsum_kernel in order.
// The row stage (adjoint_row_stage) on (psi, ct) after the lane stage:
//   per walked row bit q: un-apply rx(th_q) from psi, dth_q = -1/2 s S1 +
//   1/2 c S2, walk ct by rx^T = rx (the rx gates act on distinct bits and
//   commute, so the order differs from the JAX kernels' only by rounding);
//   then the zz stage over the full flat index: dzz_k = 1/2 sum h z_a z_b,
//   h = ct_r z_i + ct_i z_r; ds = phase * ct; x = conj(phase) z (K10's next
//   layer; skipped when not asked for).  The walked bits are the low nwalk
//   row bits of each block of 2^nwalk rows, rx angle q on the row bit of
//   stride 2^(nwalk-1-q) (K10: nwalk = all row bits; K3/K4: nkernel, or
//   nkernel - rmx under the row kron); the other row bits are CTA bits, as
//   the lanes beyond the tile are.
//   passes (ml_row_pass_kernel): the walked bits in at most two passes of
//     at most 6 bits (the high ones, then the low ones with the zz stage).
//     A CTA owns a tile of 2^11 elements: 32 consecutive lanes (full 32-byte
//     sectors a warp) by the pass's rows, filled with more lanes or rows.
//     A thread holds 8 elements of all four planes in registers and runs
//     the butterflies of 3 bits there; for more bits the tile crosses
//     shared memory once and the thread takes 8 other elements.  A CTA owns
//     its tile, so a pass may run in place.  The zz exponent of the
//     thread's 8 elements is E0 + sum_u A_u s_u + sum_uv B_uv s_u s_v over
//     its 3 register bits (s = +-1), one sweep over the pairs, which
//     ml_pair_records_kernel sorts once a call by the register bits they
//     touch (the layer's angles join them in the pass); dzz takes the 7
//     Walsh sums of h, transformed over the warp's 5 lane bits by shuffles,
//     so a pair's warp sum is one shuffle.  The phase angle goes through
//     sincospif (exact reduction, no local frame).  dth and dzz end as one
//     partial a CTA (a warp tree, then the warps in order), added by
//     colsum_tree_kernel in a fixed order.
//   K7's gate passes (gate_row_pass_kernel, gate_row_stage): the same
//     plan, tiles and register stages with a general 2x2 gate a walked bit
//     and no zz: un-apply g^dagger from psi, the eight real sums of dg =
//     ct (x) s, walk ct by g^T.  The eight sums of a bit leave the
//     registers at once, reduced over the warp by three halving exchanges
//     and a two-step butterfly (warp_sum8: 9 shuffles, lane 4k holding sum
//     k) into shared memory; the warps are then added in order into one
//     partial a CTA.  The last pass writes only ct (ds).
//   K12's passes (rx_row_stage): ml_row_pass_kernel<false> with no pairs,
//     then rx_row_pass_kernel, the last pass without the zz stage (no
//     pair records, phase or x planes), writing only ct (ds).
//   The forward passes (fwd_row_pass_kernel<ZZ, GATE, TRANS>), two planes
//     in and two out: the low walked bits on the tiles of the last pass,
//     whose thread starts on the register bits the pair records are sorted
//     by (one record set for every layer), then the high ones in place.  K1,
//     K2 and K9 (fwd_row_stage): the phase, then rx, in the first pass.  K6,
//     K8 and K11 (bfly_row_stage): no phase; K11 rx, K6 a general 2x2 gate a
//     walked bit (GATE), staged in shared memory as K7's gate passes stage
//     theirs, and K8 the same gates staged transposed (TRANS: the walk ct <-
//     g^T ct).
// Every sum across CTAs is a per-CTA partial added in a fixed order: no
// atomics, two runs agree bit for bit.  Plain f32 FMAs, no fast-math.
// Bounds at n = 20, W = 128 (r = 8192): each complex 128-deep product is
// 8 W flops an amplitude, 1.07 GFLOP (16.03 us at 67 TFLOP/s float32
// outside the tensor cores): the pair 32.05 us, dM 16.03 us; the row stage
// moves psi and ct in and ds out, 25 MB (7.5 us at 3.35 TB/s); K7's row
// stage at nkernel = 11 the same bytes for 44 flops an amplitude a bit,
// 0.51 GFLOP (7.6 us, operations).  The forward row stage moves 16.8 MB a
// layer (5.0 us, bytes) at W = 256 (K9) and at W = 128 (K1, K2, K6, K8,
// K11).

#pragma once

#include <initializer_list>

#include "lane.cuh"

namespace {

cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool all_aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* q : ptrs)
    if (!aligned16(q)) return false;
  return true;
}

// Lays out N scratch parts of the given float counts from base, each a
// multiple of 64 floats (16-byte aligned); fills ptrs (null without base)
// and returns the floats of all.
template <int N>
size_t carve(const size_t (&sizes)[N], float* base, float* (&ptrs)[N]) {
  size_t off = 0;
  for (int i = 0; i < N; ++i) {
    ptrs[i] = base ? base + off : nullptr;
    off += (sizes[i] + 63) / 64 * 64;
  }
  return off;
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

// CTAs of a product on (rows, W) planes.
long prod_ctas(int rows, int lw) {
  return static_cast<long>((rows + P_T - 1) / P_T) * ((1 << lw) / P_T);
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

// bt[l] = b[l]^T for the L (W, W) planes of b (32 x 32 tiles, grid (W /
// 32, W / 32, L), blockDim (32, 8)): the b operand of a forward product
// (K2, K9), which wide_nt_kernel reads as b[n][k].
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

// The (real, imag) planes of L (W, W) lane matrices transposed into (btr,
// bti), once a call.
cudaError_t transpose_planes(const float* br, const float* bi, float* btr, float* bti, int L, int lw,
                             cudaStream_t st) {
  const dim3 grid((1 << lw) / 32, (1 << lw) / 32, L);
  transpose_kernel<<<grid, dim3(32, 8), 0, st>>>(br, btr, lw);
  transpose_kernel<<<grid, dim3(32, 8), 0, st>>>(bi, bti, lw);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The outer pass.
// ---------------------------------------------------------------------------

// The outer pass of K2 and K15 on one in-block position p a thread: y[m] =
// sum_k mo[m][k] x[k] over the D row blocks of be positions each,
// consecutive threads on consecutive positions.  y does not alias x.
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

// The outer pass's kernel for D (1..32, a power of two), else null.
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

// CTAs of the outer pass over be in-block positions.
unsigned outer_grid(long be) { return static_cast<unsigned>((be + THREADS - 1) / THREADS); }

// One outer pass, x -> y, with a layer's (D, D) planes mor/moi.
cudaError_t outer_fwd(int d, long be, const float* kr, const float* ki, float* yr, float* yi,
                      const float* mor, const float* moi, cudaStream_t st) {
  const void* fn = outer_fwd_for(d);
  if (fn == nullptr) return cudaErrorInvalidValue;
  void* args[] = {&kr, &ki, &yr, &yi, &mor, &moi, &be};
  return cudaLaunchKernel(fn, dim3(outer_grid(be)), dim3(THREADS), args, 0, st);
}

// dM: the 64 x 64 output tiles split over row chunks of D_KC-row stages.
constexpr int D_KC = 32;
constexpr size_t DM_SMEM = sizeof(float) * 2 * 4 * D_KC * P_T;

// Row chunks of the dM partials for (rows, W): about two CTAs an SM (256
// CTAs over the (W / 64)^2 tiles), at least one stage of rows each where
// there are that many (powers of two, so the chunks divide rows).
constexpr int DM_CTAS = 256;
int dm_chunks(int rows, int lw) {
  const int tiles = 1 << (2 * (lw - 6));
  int nc = DM_CTAS / tiles;
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

// Floats of nc dM partials of (W, W) planes.
size_t dm_floats(int nc, int lw) { return static_cast<size_t>(nc) * 2 << (2 * lw); }

// dm planes (dm_out, dm_out + dm_stride) <- p^T c over all rows, as nc
// per-chunk partials (nc divides rows) added in a fixed order; part holds
// dm_floats(nc, lw).
cudaError_t wide_dm(const float* pr, const float* pi, const float* cr,
                    const float* ci, float* part, float* dm_out, long dm_stride,
                    int rows, int lw, int nc, cudaStream_t st) {
  const int tiles = 1 << (2 * (lw - 6));
  wide_dm_kernel<<<dim3(tiles, nc), THREADS, DM_SMEM, st>>>(pr, pi, cr, ci, part, rows / nc, lw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long ww = 1L << (2 * lw);
  return colsum(part, nc, static_cast<int>(2 * ww), dm_out, static_cast<int>(ww), dm_stride, st);
}

// The shared-memory limits of the lane stage's kernels; once an entry call.
cudaError_t lane_stage_prepare() {
  cudaError_t err = set_smem(reinterpret_cast<const void*>(wide_nt_kernel<2, true>), prod_smem<2>());
  if (err == cudaSuccess) err = set_smem(reinterpret_cast<const void*>(wide_dm_kernel), DM_SMEM);
  return err;
}

// The lane stage of an adjoint on (rows, W) planes: (pr, pi) <- y @
// conj(M)^T and (wr, wi) <- ct @ M^T in one launch, then the dm planes
// (dm_out, dm_out + dm_stride) <- psi^T ct over nc row chunks (part_dm
// holds dm_floats(nc, lw)).  Every plane 16-byte aligned; psi and w alias
// neither y nor ct.
cudaError_t adjoint_lane_stage(int rows, int lw, const float* yr, const float* yi,
                               const float* ctr, const float* cti, const float* mr,
                               const float* mi, float* pr, float* pi, float* wr,
                               float* wi, float* part_dm, float* dm_out,
                               long dm_stride, int nc, cudaStream_t st) {
  cudaError_t err = wide_nt<2, true>(yr, yi, ctr, cti, mr, mi, pr, pi, wr, wi, rows, lw, st);
  if (err != cudaSuccess) return err;
  return wide_dm(pr, pi, ctr, cti, part_dm, dm_out, dm_stride, rows, lw, nc, st);
}

// ---------------------------------------------------------------------------
// The row stage.
// ---------------------------------------------------------------------------

constexpr int RP_TB = 11;    // tile bits: 2^11 elements, 32 KB of four planes
constexpr int RP_MAXB = 6;   // walked row bits a pass
constexpr int RP_MAXC = 24;  // CTA bits

// One pass of the row stage.  Tile bits 0..4 are lanes 0..4, tile bits
// 5..5+nb-1 the pass's row bits, the rest more lanes, then other rows; the
// CTA index holds the remaining flat bits.
struct RowPass {
  int tb;              // tile bits (8..11)
  int nb;              // row bits of the pass (0..6): tile bits 5..
  int ncb;             // CTA bits
  int q[RP_MAXB];      // rx angle of the pass's row bit i
  int tmap[RP_TB];     // flat bit of tile bit i
  int cmap[RP_MAXC];   // flat bit of CTA bit i
};

// The row stage's plan: pass[0] the high walked bits when there are two,
// pass[npass - 1] the low ones and the zz stage; both on the same tiles.
struct RowStage {
  int nwalk, npass;
  RowPass pass[2];
};

// The passes on (2^nrb, 2^lw) planes walking the low nwalk row bits; false
// for a shape they do not take (flat indices of 8..31 bits).
bool row_stage_plan(int nrb, int lw, int nwalk, RowStage* rs) {
  const int total = nrb + lw;
  if (nwalk < 0 || nwalk > nrb || nwalk > 2 * RP_MAXB || lw < 5 || total < 8 || total > 31)
    return false;
  rs->nwalk = nwalk;
  rs->npass = nwalk > RP_MAXB ? 2 : 1;
  for (int k = 0; k < 2; ++k) {
    RowPass& rp = rs->pass[k];
    rp = RowPass{};
    if (k >= rs->npass) continue;
    const bool last = k == rs->npass - 1;
    const int lo = last ? 0 : RP_MAXB;  // walked bits [lo, hi) from the lowest
    const int hi = last ? (nwalk < RP_MAXB ? nwalk : RP_MAXB) : nwalk;
    rp.nb = hi - lo;
    rp.tb = total < RP_TB ? total : RP_TB;
    bool used[32] = {};
    int n = 0;
    for (int i = 0; i < 5; ++i) used[rp.tmap[n++] = i] = true;
    for (int i = 0; i < rp.nb; ++i) {
      used[rp.tmap[n++] = lw + lo + i] = true;
      rp.q[i] = nwalk - 1 - (lo + i);
    }
    for (int b = 5; b < total && n < rp.tb; ++b)
      if (!used[b]) used[rp.tmap[n++] = b] = true;
    for (int b = 0; b < total; ++b)
      if (!used[b]) rp.cmap[rp.ncb++] = b;
  }
  return true;
}

const RowPass& last_pass(const RowStage& rs) { return rs.pass[rs.npass - 1]; }

// CTAs and threads a CTA of each pass.
long row_ctas(const RowStage& rs) { return 1L << last_pass(rs).ncb; }
int row_threads(const RowStage& rs) { return 1 << (last_pass(rs).tb - 3); }

// Floats of the row stage's per-CTA partials and of its pair records.
size_t row_part_floats(const RowStage& rs, int npairs) {
  return static_cast<size_t>(row_ctas(rs)) * (npairs + rs.nwalk);
}
size_t pair_record_floats(int npairs) { return 4 * static_cast<size_t>(npairs) + 8; }

// Flat offset of the tile bits of e (register or thread bits); flat
// indices have at most 31 bits.
__device__ __forceinline__ int tile_flat(int e, const RowPass& rp) {
  int f = 0;
#pragma unroll
  for (int i = 0; i < RP_TB; ++i)
    if (i < rp.tb) f |= ((e >> i) & 1) << rp.tmap[i];
  return f;
}

// Flat offset of CTA blockIdx.x's CTA bits under pass rp.
__device__ __forceinline__ int cta_flat(const RowPass& rp) {
  int f = 0;
#pragma unroll
  for (int i = 0; i < RP_MAXC; ++i)
    if (i < rp.ncb) f |= ((blockIdx.x >> i) & 1) << rp.cmap[i];
  return f;
}

// Flat offsets of a thread's 8 register elements whose register bits are
// tile bits b0..b0+2.
__device__ __forceinline__ void reg_offsets(const RowPass& rp, int b0, int (&dl)[8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    dl[r] = 0;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (r & (1 << j)) dl[r] |= 1 << rp.tmap[b0 + j];
  }
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

// The pair records into shared memory, each with the layer's angle in its
// first slot (zzth[pair index]), and the slots' offsets (so[s]: the first
// record of slot s).
__device__ __forceinline__ void load_records(const int4* __restrict__ grec,
                                             const int* __restrict__ gso,
                                             const float* __restrict__ zzth, int npairs,
                                             int4* rec, int* so) {
  for (int k = threadIdx.x; k < npairs; k += blockDim.x) {
    int4 q = grec[k];
    q.x = __float_as_int(zzth[q.z]);
    rec[k] = q;
  }
  if (threadIdx.x < 8) so[threadIdx.x] = gso[threadIdx.x];
}

// The zz exponent's 7 Walsh coefficients over the thread's 3 register bits
// (slot order of ml_pair_records_kernel): each pair's angle times the signs
// of its fixed bits at the thread's flat offset f.
__device__ __forceinline__ void zz_walsh(const int4* rec, const int* so, int f, float (&co)[7]) {
#pragma unroll
  for (int sv = 0; sv < 7; ++sv) {
    co[sv] = 0.f;
    for (int k = so[sv]; k < so[sv + 1]; ++k) {
      const int4 q = rec[k];
      co[sv] += signed_by(__int_as_float(q.x), f & q.y);
    }
  }
}

// The Walsh signs of register element r: 1, s_0, s_1, s_2, s_0 s_1, s_0 s_2,
// s_1 s_2, with s_u = +1 where register bit u of r is 0.
__device__ __forceinline__ void walsh_signs(int r, float (&sg)[7]) {
  const float s0 = r & 1 ? -1.f : 1.f, s1 = r & 2 ? -1.f : 1.f, s2 = r & 4 ? -1.f : 1.f;
  sg[0] = 1.f, sg[1] = s0, sg[2] = s1, sg[3] = s2, sg[4] = s0 * s1, sg[5] = s0 * s2, sg[6] = s1 * s2;
}

// sin and cos of half the zz exponent sum_i sg[i] co[i]: the angle in units
// of pi through sincospif, which reduces its argument exactly (sincosf's
// slow path would need a local frame).
__device__ __forceinline__ void zz_sincos(const float (&co)[7], const float (&sg)[7], float* sn,
                                          float* c) {
  float expo = 0.f;
#pragma unroll
  for (int i = 0; i < 7; ++i) expo = fmaf(sg[i], co[i], expo);
  sincospif(expo * (0.5f / 3.14159265358979f), sn, c);
}

// The pair records of the last row pass, one warp a call: rec holds (0,
// fixed flat bits, pair index, 0) of every pair (the pass puts the layer's
// angle in the first slot), sorted (stably) by its Walsh slot over the
// register flat bits v0, v1, v2 of the pass's final stage: slot 0 no
// register bit, 1 + u bit u alone, 4 + (u + v - 1) bits u < v; so[s] is
// the first record of slot s (so[7] = npairs).
__global__ void ml_pair_records_kernel(const int* __restrict__ shifts, int npairs,
                                       int v0, int v1, int v2, int4* rec, int* so) {
  const int t = threadIdx.x;
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
  if (t < 8) so[t] = pick(pos, t);
  for (int k0 = 0; k0 < npairs; k0 += 32) {
    const int k = k0 + t, sl = slot_of(k);
#pragma unroll
    for (int sv = 0; sv < 7; ++sv) {
      const unsigned m = __ballot_sync(0xffffffffu, sl == sv);
      if (sl == sv) {
        const int sa = shifts[2 * k], sb = shifts[2 * k + 1];
        rec[pos[sv] + __popc(m & ((1u << t) - 1))] =
            make_int4(0, (reg(sa) < 0 ? 1 << sa : 0) | (reg(sb) < 0 ? 1 << sb : 0), k, 0);
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

// One pass of the row stage on the tile of CTA blockIdx.x: the rx bits of
// the pass on psi (pr, pi) and ct (cr, ci); not LAST: psi into (o1r, o1i)
// and ct into (o2r, o2i); LAST: ZZ, then the zz stage, x = conj(phase) z
// into (o1r, o1i) (skipped when o1r is null) and ds = phase * ct into
// (o2r, o2i); without ZZ (K12) only ct into (o2r, o2i).  Any output may
// alias the planes it comes from.  Writes its dth (and ZZ: every dzz)
// column of part[blockIdx.x] = (dzz[0..npairs), dth[0..nwalk)).  ZZ reads
// the pair records grec and their slot offsets gso (ml_pair_records_kernel)
// and the layer's angles zzth.  blockDim.x = 2^(tb-3), 8 elements a thread.
template <bool LAST, bool ZZ>
__device__ __forceinline__ void
row_pass(const float* pr, const float* pi, const float* cr, const float* ci,
         float* o1r, float* o1i, float* o2r, float* o2i, float* part,
         const int4* __restrict__ grec, const int* __restrict__ gso,
         const float* __restrict__ zzth, int npairs,
         const float* __restrict__ th, int nwalk, const RowPass& rp) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int nel = 1 << rp.tb, warps = blockDim.x >> 5;
  float* xs = smem;
  // ZZ: the pair records with the layer's angles and the slots' offsets:
  // slot s holds records [so[s], so[s + 1])
  int4* rec = reinterpret_cast<int4*>(xs + (rp.nb > 3 ? 4 * nel : 0));
  float* red = reinterpret_cast<float*>(rec + (ZZ ? npairs : 0));  // [warp][dth, dzz]
  const int nred = RP_MAXB + npairs;
  float* cs = red + warps * nred;
  int* so = reinterpret_cast<int*>(cs + 2 * RP_MAXB);
  if (t < rp.nb) sincosf(0.5f * th[pick(rp.q, t)], &cs[2 * t + 1], &cs[2 * t]);
  if (ZZ) load_records(grec, gso, zzth, npairs, rec, so);
  const int cbase = cta_flat(rp);
  __syncthreads();

  // stage 1: tile bits 5..7 in registers, the thread on tile bits 0..4, 8..
  float zr[8], zi[8], ur[8], ui[8], d[RP_MAXB];
#pragma unroll
  for (int i = 0; i < RP_MAXB; ++i) d[i] = 0.f;
  const int e1 = (t & 31) | ((t >> 5) << 8);
  int f = cbase + tile_flat(e1, rp);
  int dl[8];
  reg_offsets(rp, 5, dl);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    zr[r] = pr[f + dl[r]];
    zi[r] = pi[f + dl[r]];
    ur[r] = cr[f + dl[r]];
    ui[r] = ci[f + dl[r]];
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
    reg_offsets(rp, 8, dl);
    row_butterflies<3>(zr, zi, ur, ui, d, cs, rp.nb);
  }
  const int lane = t & 31, warp = t >> 5;
  if (!ZZ) {
    // the register bits' offsets taken again from the plan: held as dl[8]
    // across the stores they spill at 64 registers
    const bool two = rp.nb > 3;
    const int s0 = 1 << (two ? rp.tmap[8] : rp.tmap[5]), s1 = 1 << (two ? rp.tmap[9] : rp.tmap[6]);
    const int s2 = 1 << (two ? rp.tmap[10] : rp.tmap[7]);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int off = f + (r & 1 ? s0 : 0) + (r & 2 ? s1 : 0) + (r & 4 ? s2 : 0);
      if (!LAST) {
        o1r[off] = zr[r];
        o1i[off] = zi[r];
      }
      o2r[off] = ur[r];
      o2i[off] = ui[r];
    }
  } else {
    // zz: the exponent's 7 Walsh coefficients over the 3 register bits
    float co[7];
    zz_walsh(rec, so, f, co);
    float hw[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // Walsh sums of h
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float sg[7], sn, c;
      walsh_signs(r, sg);
      zz_sincos(co, sg, &sn, &c);
      const float u_r = ur[r], u_i = ui[r], z_r = zr[r], z_i = zi[r];
      const float h = fmaf(u_r, z_i, u_i * z_r);
#pragma unroll
      for (int i = 0; i < 7; ++i) hw[i] = fmaf(sg[i], h, hw[i]);
      const int off = f + dl[r];
      o2r[off] = fmaf(sn, u_i, c * u_r);
      o2i[off] = fmaf(-sn, u_r, c * u_i);
      if (o1r) {
        o1r[off] = fmaf(-sn, z_i, c * z_r);
        o1i[off] = fmaf(sn, z_r, c * z_i);
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
  float* mypart = part + static_cast<long>(blockIdx.x) * (npairs + nwalk);
  const int nout = LAST ? RP_MAXB + npairs : rp.nb;
  for (int k = t; k < nout; k += blockDim.x) {
    if (k >= rp.nb && k < RP_MAXB) continue;
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += red[w * nred + k];
    mypart[k < RP_MAXB ? npairs + pick(rp.q, k) : k - RP_MAXB] = s;
  }
}

// The passes of K3, K4 and K10 (row_pass with the zz stage in the last)
// and K12's first.  64 registers (4 CTAs an SM: at n = 20 the 512 CTAs
// run in one wave) spill nothing since the first pass takes its store
// offsets from the plan (it spilled at 64 when it kept them as dl[8], and
// ran at 80, 3 CTAs an SM, about 5 % slower in K12).
template <bool LAST>
__global__ void __launch_bounds__(THREADS, 4)
ml_row_pass_kernel(const float* pr, const float* pi, const float* cr, const float* ci,
                   float* o1r, float* o1i, float* o2r, float* o2i, float* part,
                   const int4* __restrict__ grec, const int* __restrict__ gso,
                   const float* __restrict__ zzth, int npairs,
                   const float* __restrict__ th, int nwalk, RowPass rp) {
  row_pass<LAST, LAST>(pr, pi, cr, ci, o1r, o1i, o2r, o2i, part, grec, gso, zzth, npairs, th,
                       nwalk, rp);
}

// K12's last pass: row_pass without the zz stage (no pair records, phase
// or x planes); ct into (o2r, o2i).  Its first pass is
// ml_row_pass_kernel<false> with no pairs.
__global__ void __launch_bounds__(THREADS, 4)
rx_row_pass_kernel(const float* pr, const float* pi, const float* cr, const float* ci,
                   float* o2r, float* o2i, float* part, const float* __restrict__ th, int nwalk,
                   RowPass rp) {
  row_pass<true, false>(pr, pi, cr, ci, nullptr, nullptr, o2r, o2i, part, nullptr, nullptr, nullptr,
                        0, th, nwalk, rp);
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

cudaError_t colsum_tree(const float* part, int nb, int ncols, float* out, cudaStream_t st) {
  if (ncols > 0) colsum_tree_kernel<<<ncols, THREADS, 0, st>>>(part, nb, ncols, out);
  return cudaGetLastError();
}

const void* row_pass_fn(bool last) {
  return last ? reinterpret_cast<const void*>(ml_row_pass_kernel<true>)
              : reinterpret_cast<const void*>(ml_row_pass_kernel<false>);
}

// The row passes' shared-memory limits; once an entry call.
cudaError_t row_stage_prepare(const RowStage& rs, int npairs) {
  cudaError_t err = set_smem(row_pass_fn(false), row_pass_smem(rs.pass[0], npairs, false));
  if (err == cudaSuccess) err = set_smem(row_pass_fn(true), row_pass_smem(last_pass(rs), npairs, true));
  return err;
}

// The records of the row stage's zz sweep (rec: pair_record_floats floats,
// the slot offsets after npairs int4), once an entry call: they depend on
// the pairs and the plan, not on a layer's angles.
cudaError_t pair_records(const RowStage& rs, const int* shifts, int npairs, float* rec,
                         cudaStream_t st) {
  const RowPass& last = last_pass(rs);
  const int rb = last.nb > 3 ? 8 : 5;  // the final stage's register tile bits
  ml_pair_records_kernel<<<1, 32, 0, st>>>(shifts, npairs, last.tmap[rb], last.tmap[rb + 1],
                                           last.tmap[rb + 2], reinterpret_cast<int4*>(rec),
                                           reinterpret_cast<int*>(rec + 4 * static_cast<size_t>(npairs)));
  return cudaGetLastError();
}

// The row stage of one layer on psi (pr, pi) and ct (cr, ci): with two
// passes the first takes them into (mpr, mpi) and (mcr, mci) (the same
// planes or others), then the last: x into (xr, xi) unless xr is null, ds
// into (dsr, dsi); grads[0..npairs + nwalk) <- (dzz, dth) through the
// per-CTA partials part (row_part_floats).  rec from pair_records; zzth
// and th the layer's angles.
cudaError_t adjoint_row_stage(const RowStage& rs, const float* pr, const float* pi,
                              const float* cr, const float* ci, float* mpr, float* mpi,
                              float* mcr, float* mci, float* xr, float* xi, float* dsr,
                              float* dsi, float* part, const float* rec, const float* zzth,
                              int npairs, const float* th, float* grads, cudaStream_t st) {
  const RowPass& last = last_pass(rs);
  const unsigned grid = static_cast<unsigned>(row_ctas(rs));
  const int threads = row_threads(rs);
  if (rs.npass == 2) {
    ml_row_pass_kernel<false><<<grid, threads, row_pass_smem(rs.pass[0], npairs, false), st>>>(
        pr, pi, cr, ci, mpr, mpi, mcr, mci, part, nullptr, nullptr, nullptr, npairs, th, rs.nwalk,
        rs.pass[0]);
    pr = mpr, pi = mpi, cr = mcr, ci = mci;
  }
  const int4* r4 = reinterpret_cast<const int4*>(rec);
  const int* so = reinterpret_cast<const int*>(rec + 4 * static_cast<size_t>(npairs));
  ml_row_pass_kernel<true><<<grid, threads, row_pass_smem(last, npairs, true), st>>>(
      pr, pi, cr, ci, xr, xi, dsr, dsi, part, r4, so, zzth, npairs, th, rs.nwalk, last);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return colsum_tree(part, static_cast<int>(grid), npairs + rs.nwalk, grads, st);
}

// ---------------------------------------------------------------------------
// The general-gate adjoint pass (K7) and the forward passes (K1, K2, K6,
// K8, K9, K11), on the row stage's plan.
// ---------------------------------------------------------------------------

// The warp sums of a[0..8) without a shuffle tree a value: three halving
// exchanges (lane bits 4, 3, 2 pick the half a lane keeps), then a butterfly
// over lane bits 0 and 1; lane L ends with the sum of a[L >> 2], in a fixed
// order.  Nine shuffles where eight trees take forty.
__device__ __forceinline__ float warp_sum8(float (&a)[8], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float send = b4 ? a[k] : a[k + 4];
    a[k] = (b4 ? a[k + 4] : a[k]) + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float send = b3 ? a[k] : a[k + 2];
    a[k] = (b3 ? a[k + 2] : a[k]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const float send = b2 ? a[0] : a[1];
  float v = (b2 ? a[1] : a[0]) + __shfl_xor_sync(0xffffffffu, send, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 1);
}

// The gate butterflies of pass bits i0..i0+2 on the thread's 8 elements,
// register bit j = pass bit i0 + j, gate g + 8 (i0 + j) = (g00, g01, g10,
// g11) as (re, im): un-apply g^dagger from psi (z), the eight sums of
// dg[a][b] = ct[bit a] s[bit b] (plain products; s the state before the
// gate, ct the cotangent after it), reduced over the warp at once into
// wred[8 (i0 + j) ..] (lanes 0, 4, .., 28), and the walk of ct (u) by g^T.
template <int I0>
__device__ __forceinline__ void gate_butterflies(float (&zr)[8], float (&zi)[8], float (&ur)[8],
                                                 float (&ui)[8], const float* g, float* wred,
                                                 int nb, int lane) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (I0 + j >= nb) continue;
    const float* m = g + 8 * (I0 + j);
    const float g00r = m[0], g00i = m[1], g01r = m[2], g01i = m[3];
    const float g10r = m[4], g10i = m[5], g11r = m[6], g11i = m[7];
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // dg 00, 01, 10, 11 as (re, im)
#pragma unroll
    for (int lo = 0; lo < 8; ++lo) {
      if (lo & (1 << j)) continue;
      const int hi = lo | (1 << j);
      // un-apply: s <- g^dagger s, g^dagger = [[g00*, g10*], [g01*, g11*]]
      const float ar = zr[lo], ai = zi[lo], br = zr[hi], bi = zi[hi];
      const float lr = fmaf(g10i, bi, fmaf(g10r, br, fmaf(g00i, ai, g00r * ar)));
      const float li = fmaf(-g10i, br, fmaf(g10r, bi, fmaf(-g00i, ar, g00r * ai)));
      const float hr = fmaf(g11i, bi, fmaf(g11r, br, fmaf(g01i, ai, g01r * ar)));
      const float hm = fmaf(-g11i, br, fmaf(g11r, bi, fmaf(-g01i, ar, g01r * ai)));
      zr[lo] = lr, zi[lo] = li, zr[hi] = hr, zi[hi] = hm;
      const float xr = ur[lo], xi = ui[lo], vr = ur[hi], vi = ui[hi];
      acc[0] = fmaf(-xi, li, fmaf(xr, lr, acc[0]));
      acc[1] = fmaf(xi, lr, fmaf(xr, li, acc[1]));
      acc[2] = fmaf(-xi, hm, fmaf(xr, hr, acc[2]));
      acc[3] = fmaf(xi, hr, fmaf(xr, hm, acc[3]));
      acc[4] = fmaf(-vi, li, fmaf(vr, lr, acc[4]));
      acc[5] = fmaf(vi, lr, fmaf(vr, li, acc[5]));
      acc[6] = fmaf(-vi, hm, fmaf(vr, hr, acc[6]));
      acc[7] = fmaf(vi, hr, fmaf(vr, hm, acc[7]));
      // walk: ct <- g^T ct, g^T = [[g00, g10], [g01, g11]]
      ur[lo] = fmaf(-g10i, vi, fmaf(g10r, vr, fmaf(-g00i, xi, g00r * xr)));
      ui[lo] = fmaf(g10i, vr, fmaf(g10r, vi, fmaf(g00i, xr, g00r * xi)));
      ur[hi] = fmaf(-g11i, vi, fmaf(g11r, vr, fmaf(-g01i, xi, g01r * xr)));
      ui[hi] = fmaf(g11i, vr, fmaf(g11r, vi, fmaf(g01i, xr, g01r * xi)));
    }
    const float v = warp_sum8(acc, lane);
    if ((lane & 3) == 0) wred[8 * (I0 + j) + (lane >> 2)] = v;
  }
}

// Shared bytes of a gate pass: the exchange tile (nb > 3), the warps' dg
// sums (8 a pass bit) and the pass bits' gates (8 floats each).
size_t gate_pass_smem(const RowPass& rp) {
  const int warps = (1 << (rp.tb - 3)) / 32;
  return sizeof(float) * ((rp.nb > 3 ? 4 << rp.tb : 0) + (warps + 1) * 8 * RP_MAXB);
}

// K7's row pass on the tile of CTA blockIdx.x, psi (pr, pi) and ct (cr,
// ci): gate_butterflies for each pass bit i with gate rp.q[i] of the
// (nkernel, 4) planes gr/gi; ct into (o2r, o2i) and, not LAST, psi into
// (o1r, o1i) (the last pass writes no psi).  Any output may alias the
// planes it comes from.  Writes the pass bits' columns of part[blockIdx.x]
// = (re of dg (nkernel, 4), im of dg).  blockDim.x = 2^(tb-3), 8 elements
// a thread.  64 registers (4 CTAs an SM: at n = 20 the 512 CTAs run in one
// wave) spill nothing; at 2 CTAs an SM the pass takes 86-88 and runs about
// a tenth slower.
template <bool LAST>
__global__ void __launch_bounds__(THREADS, 4)
gate_row_pass_kernel(const float* pr, const float* pi, const float* cr, const float* ci,
                     float* o1r, float* o1i, float* o2r, float* o2i, float* part,
                     const float* __restrict__ gr, const float* __restrict__ gi, int nkernel,
                     RowPass rp) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nel = 1 << rp.tb, warps = blockDim.x >> 5;
  float* xs = smem;
  float* red = xs + (rp.nb > 3 ? 4 * nel : 0);  // [warp][8 a pass bit]
  float* g = red + warps * 8 * RP_MAXB;
  if (t < 4 * rp.nb) {
    const int i = t >> 2, e = t & 3, q = pick(rp.q, i);
    g[8 * i + 2 * e] = gr[4 * q + e];
    g[8 * i + 2 * e + 1] = gi[4 * q + e];
  }
  const int cbase = cta_flat(rp);
  __syncthreads();

  // stage 1: tile bits 5..7 in registers, the thread on tile bits 0..4, 8..
  float zr[8], zi[8], ur[8], ui[8];
  const int e1 = (t & 31) | ((t >> 5) << 8);
  int f = cbase + tile_flat(e1, rp);
  int dl[8];
  reg_offsets(rp, 5, dl);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    zr[r] = pr[f + dl[r]];
    zi[r] = pi[f + dl[r]];
    ur[r] = cr[f + dl[r]];
    ui[r] = ci[f + dl[r]];
  }
  float* wred = red + warp * 8 * RP_MAXB;
  gate_butterflies<0>(zr, zi, ur, ui, g, wred, rp.nb, lane);
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
    reg_offsets(rp, 8, dl);
    gate_butterflies<3>(zr, zi, ur, ui, g, wred, rp.nb, lane);
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (!LAST) {
      o1r[f + dl[r]] = zr[r];
      o1i[f + dl[r]] = zi[r];
    }
    o2r[f + dl[r]] = ur[r];
    o2i[f + dl[r]] = ui[r];
  }
  __syncthreads();
  // the warps' sums in order: sum k = 8 i + 2 entry + (re, im) of pass bit i
  float* mypart = part + static_cast<long>(blockIdx.x) * 8 * nkernel;
  for (int k = t; k < 8 * rp.nb; k += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += red[w * 8 * RP_MAXB + k];
    mypart[(k & 1) * 4 * nkernel + 4 * pick(rp.q, k >> 3) + ((k & 7) >> 1)] = s;
  }
}

// Floats of the gate passes' per-CTA partials.
size_t gate_part_floats(const RowStage& rs) {
  return static_cast<size_t>(row_ctas(rs)) * 8 * rs.nwalk;
}

// The gate passes' shared bytes (the larger pass's).
size_t gate_stage_smem(const RowStage& rs) {
  const size_t a = gate_pass_smem(rs.pass[0]), b = gate_pass_smem(last_pass(rs));
  return a > b ? a : b;
}

const void* gate_pass_fn(bool last) {
  return last ? reinterpret_cast<const void*>(gate_row_pass_kernel<true>)
              : reinterpret_cast<const void*>(gate_row_pass_kernel<false>);
}

// The gate passes' shared-memory limits; once an entry call.
cudaError_t gate_stage_prepare(const RowStage& rs) {
  cudaError_t err = set_smem(gate_pass_fn(false), gate_stage_smem(rs));
  if (err == cudaSuccess) err = set_smem(gate_pass_fn(true), gate_stage_smem(rs));
  return err;
}

// K7's row stage on psi (pr, pi) and ct (cr, ci), gates gr/gi (nwalk, 4):
// with two passes the first takes psi into (mpr, mpi) and ct into (dsr,
// dsi), then the last takes ct into (dsr, dsi) (psi is not needed after
// it); dg (2, nwalk, 4) <- the per-CTA partials part (gate_part_floats),
// added by colsum_tree.
cudaError_t gate_row_stage(const RowStage& rs, const float* pr, const float* pi, const float* cr,
                           const float* ci, float* mpr, float* mpi, float* dsr, float* dsi,
                           float* part, const float* gr, const float* gi, float* dg,
                           cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>(row_ctas(rs));
  const int threads = row_threads(rs);
  const size_t smem = gate_stage_smem(rs);
  if (rs.npass == 2) {
    gate_row_pass_kernel<false><<<grid, threads, smem, st>>>(pr, pi, cr, ci, mpr, mpi, dsr, dsi,
                                                             part, gr, gi, rs.nwalk, rs.pass[0]);
    pr = mpr, pi = mpi, cr = dsr, ci = dsi;
  }
  gate_row_pass_kernel<true><<<grid, threads, smem, st>>>(pr, pi, cr, ci, nullptr, nullptr, dsr,
                                                          dsi, part, gr, gi, rs.nwalk, last_pass(rs));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return colsum_tree(part, static_cast<int>(grid), 8 * rs.nwalk, dg, st);
}

// K12's row stage on y (pr, pi) and ct (cr, ci) walking the rx angles th
// (nwalk): with two passes the first (ml_row_pass_kernel<false>, no pairs)
// takes psi into (mpr, mpi) and ct into (dsr, dsi), then the last
// (rx_row_pass_kernel) takes ct into (dsr, dsi) (psi is not needed after
// it); dth (nwalk) <- the per-CTA partials part (row_part_floats(rs, 0)),
// added by colsum_tree.  Both passes take less than the default 48 KB of
// dynamic shared memory.
cudaError_t rx_row_stage(const RowStage& rs, const float* pr, const float* pi, const float* cr,
                         const float* ci, float* mpr, float* mpi, float* dsr, float* dsi,
                         float* part, const float* th, float* dth, cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>(row_ctas(rs));
  const int threads = row_threads(rs);
  if (rs.npass == 2) {
    ml_row_pass_kernel<false><<<grid, threads, row_pass_smem(rs.pass[0], 0, false), st>>>(
        pr, pi, cr, ci, mpr, mpi, dsr, dsi, part, nullptr, nullptr, nullptr, 0, th, rs.nwalk,
        rs.pass[0]);
    pr = mpr, pi = mpi, cr = dsr, ci = dsi;
  }
  rx_row_pass_kernel<<<grid, threads, row_pass_smem(last_pass(rs), 0, true), st>>>(
      pr, pi, cr, ci, dsr, dsi, part, th, rs.nwalk, last_pass(rs));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return colsum_tree(part, static_cast<int>(grid), rs.nwalk, dth, st);
}

// The forward butterflies of pass bits i0..i0+2 on the thread's 8
// elements, register bit j = pass bit i0 + j.  GATE: the general gate co +
// 8 (i0 + j) = (g00, g01, g10, g11) as (re, im), lo' = g00 lo + g01 hi and
// hi' = g10 lo + g11 hi, each complex multiply-add two fmaf a plane; else
// rx(th) = [[c, -i s], [-i s, c]] with co + 2 (i0 + j) = (c, s).
template <int I0, bool GATE>
__device__ __forceinline__ void fwd_butterflies(float (&zr)[8], float (&zi)[8], const float* co,
                                                int nb) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (I0 + j >= nb) continue;
    if constexpr (GATE) {
      const float* m = co + 8 * (I0 + j);
      const float g00r = m[0], g00i = m[1], g01r = m[2], g01i = m[3];
      const float g10r = m[4], g10i = m[5], g11r = m[6], g11i = m[7];
#pragma unroll
      for (int lo = 0; lo < 8; ++lo) {
        if (lo & (1 << j)) continue;
        const int hi = lo | (1 << j);
        const float ar = zr[lo], ai = zi[lo], br = zr[hi], bi = zi[hi];
        zr[lo] = fmaf(-g01i, bi, fmaf(g01r, br, fmaf(-g00i, ai, g00r * ar)));
        zi[lo] = fmaf(g01i, br, fmaf(g01r, bi, fmaf(g00i, ar, g00r * ai)));
        zr[hi] = fmaf(-g11i, bi, fmaf(g11r, br, fmaf(-g10i, ai, g10r * ar)));
        zi[hi] = fmaf(g11i, br, fmaf(g11r, bi, fmaf(g10i, ar, g10r * ai)));
      }
    } else {
      const float c = co[2 * (I0 + j)], sn = co[2 * (I0 + j) + 1];
#pragma unroll
      for (int lo = 0; lo < 8; ++lo) {
        if (lo & (1 << j)) continue;
        const int hi = lo | (1 << j);
        const float ar = zr[lo], ai = zi[lo], br = zr[hi], bi = zi[hi];
        zr[lo] = fmaf(sn, bi, c * ar), zi[lo] = fmaf(-sn, br, c * ai);
        zr[hi] = fmaf(sn, ai, c * br), zi[hi] = fmaf(-sn, ar, c * bi);
      }
    }
  }
}

// Floats a pass bit of a forward pass's butterfly coefficients: a gate's
// four complex entries, or rx's cos and sin.
__host__ __device__ constexpr int fwd_coef_floats(bool gate) { return gate ? 8 : 2; }

// Shared bytes of a forward pass: the exchange tile of two planes (nb >
// 3), ZZ: the pair records; the pass bits' coefficients and the slots'
// offsets.
size_t fwd_pass_smem(const RowPass& rp, int npairs, bool zz, bool gate = false) {
  return sizeof(float) * ((rp.nb > 3 ? 2 << rp.tb : 0) + fwd_coef_floats(gate) * RP_MAXB + 8) +
         (zz ? sizeof(int4) * npairs : 0);
}

// A forward row pass on the tile of CTA blockIdx.x, x -> y: ZZ (K1's,
// K2's and K9's first pass, on the last pass's tiles) first the phase
// exp(-i/2 sum_k th_k z_a z_b), from the pair records grec/gso
// (pair_records) and the layer's angles zzth, then a butterfly on each pass
// bit i: GATE (K6) gate rp.q[i] of the (nwalk, 4) planes c1/c2 = gr/gi,
// with TRANS (K8) its transpose, else (K1, K2, K9, K11) rx(th_q) with q =
// rp.q[i] and c1 = th (the gates act on distinct bits and commute).  With
// more than 3 pass bits the thread first holds tile bits 8..10 in registers
// (those the records are sorted by), then crosses shared memory to tile
// bits 5..7.  y may alias x.  64 registers (4 CTAs an SM: at n = 20 the 512
// CTAs run in one wave).
template <bool ZZ, bool GATE, bool TRANS>
__global__ void __launch_bounds__(THREADS, 4)
fwd_row_pass_kernel(const float* xr, const float* xi, float* yr, float* yi,
                    const int4* __restrict__ grec, const int* __restrict__ gso,
                    const float* __restrict__ zzth, int npairs, const float* __restrict__ c1,
                    const float* __restrict__ c2, RowPass rp) {
  static_assert(GATE || !TRANS, "only a gate is staged transposed");
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int nel = 1 << rp.tb;
  const bool two = rp.nb > 3;
  float* xs = smem;
  int4* rec = reinterpret_cast<int4*>(xs + (two ? 2 * nel : 0));
  float* co = reinterpret_cast<float*>(rec + (ZZ ? npairs : 0));  // the pass bits' coefficients
  int* so = reinterpret_cast<int*>(co + fwd_coef_floats(GATE) * RP_MAXB);
  if constexpr (GATE) {
    if (t < 4 * rp.nb) {
      // entry e = 2 row + column of the staged gate; TRANS reads g's entry
      // 2 column + row
      const int i = t >> 2, e = t & 3, q = pick(rp.q, i);
      const int src = TRANS ? ((e & 1) << 1) | (e >> 1) : e;
      co[8 * i + 2 * e] = c1[4 * q + src];
      co[8 * i + 2 * e + 1] = c2[4 * q + src];
    }
  } else if (t < rp.nb) {
    sincosf(0.5f * c1[pick(rp.q, t)], &co[2 * t + 1], &co[2 * t]);
  }
  if (ZZ) load_records(grec, gso, zzth, npairs, rec, so);
  const int cbase = cta_flat(rp);
  __syncthreads();

  const int e1 = (t & 31) | ((t >> 5) << 8);
  int f = cbase + tile_flat(two ? t : e1, rp);
  int dl[8];
  reg_offsets(rp, two ? 8 : 5, dl);
  float zr[8], zi[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    zr[r] = xr[f + dl[r]];
    zi[r] = xi[f + dl[r]];
  }
  if (ZZ) {
    float cz[7];
    zz_walsh(rec, so, f, cz);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float sg[7], sn, c;
      walsh_signs(r, sg);
      zz_sincos(cz, sg, &sn, &c);
      const float ar = zr[r], ai = zi[r];
      zr[r] = fmaf(sn, ai, c * ar), zi[r] = fmaf(-sn, ar, c * ai);
    }
  }
  if (two) {
    fwd_butterflies<3, GATE>(zr, zi, co, rp.nb);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int e = t | (r << 8);
      xs[e] = zr[r], xs[nel + e] = zi[r];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int e = e1 | (r << 5);
      zr[r] = xs[e], zi[r] = xs[nel + e];
    }
    f = cbase + tile_flat(e1, rp);
    reg_offsets(rp, 5, dl);
  }
  fwd_butterflies<0, GATE>(zr, zi, co, rp.nb);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    yr[f + dl[r]] = zr[r];
    yi[f + dl[r]] = zi[r];
  }
}

// K1's, K2's and K9's forward passes: the zz pass (first) and the other.
const void* fwd_pass_fn(bool zz) {
  return zz ? reinterpret_cast<const void*>(fwd_row_pass_kernel<true, false, false>)
            : reinterpret_cast<const void*>(fwd_row_pass_kernel<false, false, false>);
}

// The forward passes' shared-memory limits; once an entry call.
cudaError_t fwd_stage_prepare(const RowStage& rs, int npairs) {
  cudaError_t err = set_smem(fwd_pass_fn(true), fwd_pass_smem(last_pass(rs), npairs, true));
  if (err == cudaSuccess) err = set_smem(fwd_pass_fn(false), fwd_pass_smem(rs.pass[0], npairs, false));
  return err;
}

// The row stage of one layer of K1, K2 and K9, x -> y (y may alias x):
// the phase and the low walked bits in the last pass's tiles, then (two
// passes) the high ones in place.  rec from pair_records; zzth and th the
// layer's angles.  With no walked bit (K1 under the row kron, rmx =
// nkernel) the one pass is the phase alone.
cudaError_t fwd_row_stage(const RowStage& rs, const float* xr, const float* xi, float* yr,
                          float* yi, const float* rec, const float* zzth, int npairs,
                          const float* th, cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>(row_ctas(rs));
  const int threads = row_threads(rs);
  const int4* r4 = reinterpret_cast<const int4*>(rec);
  const int* so = reinterpret_cast<const int*>(rec + 4 * static_cast<size_t>(npairs));
  fwd_row_pass_kernel<true, false, false><<<grid, threads, fwd_pass_smem(last_pass(rs), npairs, true), st>>>(
      xr, xi, yr, yi, r4, so, zzth, npairs, th, nullptr, last_pass(rs));
  if (rs.npass == 2)
    fwd_row_pass_kernel<false, false, false><<<grid, threads, fwd_pass_smem(rs.pass[0], npairs, false), st>>>(
        yr, yi, yr, yi, nullptr, nullptr, nullptr, npairs, th, nullptr, rs.pass[0]);
  return cudaGetLastError();
}

// The row stage of K6 (GATE: the general gates c1/c2 = gr/gi, (nwalk, 4)
// planes), K8 (GATE and TRANS: the same planes, each gate transposed) and
// K11 (rx, c1 = th), x -> y (y may alias x): K9's passes without the
// phase, the low walked bits on the last pass's tiles, then (two passes)
// the high ones in place.
template <bool GATE, bool TRANS>
cudaError_t bfly_row_stage(const RowStage& rs, const float* xr, const float* xi, float* yr,
                           float* yi, const float* c1, const float* c2, cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>(row_ctas(rs));
  const int threads = row_threads(rs);
  const size_t lo = fwd_pass_smem(last_pass(rs), 0, false, GATE);
  const size_t hi = fwd_pass_smem(rs.pass[0], 0, false, GATE);
  const void* kern = reinterpret_cast<const void*>(fwd_row_pass_kernel<false, GATE, TRANS>);
  // a plan record may have set a smaller limit on this kernel
  cudaError_t err = set_smem(kern, lo > hi ? lo : hi);
  if (err != cudaSuccess) return err;
  fwd_row_pass_kernel<false, GATE, TRANS><<<grid, threads, lo, st>>>(xr, xi, yr, yi, nullptr, nullptr,
                                                                     nullptr, 0, c1, c2, last_pass(rs));
  if (rs.npass == 2)
    fwd_row_pass_kernel<false, GATE, TRANS><<<grid, threads, hi, st>>>(yr, yi, yr, yi, nullptr, nullptr,
                                                                       nullptr, 0, c1, c2, rs.pass[0]);
  return cudaGetLastError();
}

}  // namespace
