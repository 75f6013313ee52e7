// Row-kron stages of the FUSE_ROWM branch (K13 inside tcng_zzrx_fwd, K14
// inside tcng_zzrx_bwd) on the (r, 128) float32 plane pair of a complex64
// statevector.  Layout index = row * 128 + lane.
//
// They replace kernels_rowlayer._rowm_fwd_stage and _rowm_bwd_stage, the
// rmx > 0 branch of the Pallas zzrx kernels: the top rmx row bits of each
// block of rb = 2^nkernel rows ride as ONE (R, R) left-matmul, R = 2^rmx,
// by M7 = kron(rx(th_0), ..., rx(th_{rmx-1})), instead of rmx butterflies.
// Each block is seen as an R x C row-major matrix, C = rb / R * 128 (at
// n = 20: 8 blocks of 128 x 1024 complex).
//
//   rowm_apply_kernel<false> (K13): y_b = M7 x_b;
//   rowm_apply_kernel<true> (K14a): x_b = M7^dagger y_b (the un-apply) and
//     c'_b = M7^T c_b (the cotangent walk), sharing the M7 tiles;
//   rowm_dm_kernel + colsum_kernel (K14b): dM7 = sum_b c_b x_b^T, the
//     non-conjugating product, as one partial a chunk of columns added in
//     a fixed order (no float atomics: bit for bit over two runs).
//
// Design.  A TPU kernel block keeps 1 MB in VMEM; here a CTA owns CW
// columns of one block for ALL R rows (64 KB of planes), loads them whole
// and then writes, so the stage may run in place, and walks the R output
// rows in groups of 32 with those rows of M7 (or columns, for the
// transposes) staged in shared memory: plain float32 FMAs, 4 output rows x
// CW/32 columns a thread.  The M7 planes (128 KB at R = 128) do not fit
// beside pass A's 64 KB tile and a second buffer, so this is a pass of its
// own over the state, which stays in the 50 MB L2 (8.4 MB at n = 20).
// Bound: operations, 8 R flops an amplitude a product.

#pragma once

#include "lane.cuh"

namespace {

// output rows a CTA takes per staged group of M7 (8 warps x 4 rows)
constexpr int RM_GROUP = 32;
// dM7 partials: a 32 x 32 output tile, columns staged 32 at a time
constexpr int RD_T = 32;
constexpr int RD_KS = 32;

// BWD false: (o1) <- M (i1).  BWD true: (o1) <- M^dagger (i1) and
// (o2) <- M^T (i2).  M is R x R (R = 2^lr); a block's matrix has C = 2^lc
// columns.  o1 may alias i1 and o2 may alias i2.
template <bool BWD>
__global__ void __launch_bounds__(THREADS)
rowm_apply_kernel(const float* i1r, const float* i1i, const float* i2r,
                  const float* i2i, float* o1r, float* o1i, float* o2r,
                  float* o2i, const float* __restrict__ mr,
                  const float* __restrict__ mi, int lr, int lc) {
  constexpr int CW = BWD ? 32 : 64;  // columns a CTA
  constexpr int NQ = CW / 32;        // columns a thread
  constexpr int NP = BWD ? 4 : 2;    // planes of the tile
  extern __shared__ float smem[];
  const int R = 1 << lr;
  const int RS = R + 1;  // padded row stride of the staged M7 rows
  const long C = 1L << lc;
  const long tiles = C / CW;
  const long b = blockIdx.x / tiles;
  const long base = (b << lr) * C + (blockIdx.x % tiles) * CW;
  const int plane = R * CW;
  float* xs = smem;                  // NP planes of R x CW
  float* ms_r = smem + NP * plane;   // RM_GROUP x RS
  float* ms_i = ms_r + RM_GROUP * RS;
  for (int e = threadIdx.x; e < plane; e += THREADS) {
    const long off = base + (e / CW) * C + e % CW;
    xs[e] = i1r[off];
    xs[plane + e] = i1i[off];
    if (BWD) {
      xs[2 * plane + e] = i2r[off];
      xs[3 * plane + e] = i2i[off];
    }
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = R < RM_GROUP ? R : RM_GROUP;  // rows of a group
  for (int g0 = 0; g0 < R; g0 += RM_GROUP) {
    __syncthreads();  // the tile is loaded / the previous group is consumed
    // ms[rr][k] = M[g0 + rr][k] (forward) or M[k][g0 + rr] (transposes);
    // consecutive threads read consecutive addresses either way
    for (int e = threadIdx.x; e < gr * R; e += THREADS) {
      const int rr = BWD ? e % gr : e / R;
      const int k = BWD ? e / gr : e % R;
      const long src = BWD ? static_cast<long>(k) * R + g0 + rr
                           : static_cast<long>(g0 + rr) * R + k;
      ms_r[rr * RS + k] = mr[src];
      ms_i[rr * RS + k] = mi[src];
    }
    __syncthreads();
    const int row0 = warp * 4;
    if (row0 >= gr) continue;  // idle warps of a small R (no barrier below)
    float a_r[4][NQ], a_i[4][NQ], b_r[4][NQ], b_i[4][NQ];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < NQ; ++q) a_r[a][q] = a_i[a][q] = b_r[a][q] = b_i[a][q] = 0.f;
    for (int k = 0; k < R; ++k) {
      float u_r[NQ], u_i[NQ], v_r[NQ], v_i[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int e = k * CW + lane + 32 * q;
        u_r[q] = xs[e];
        u_i[q] = xs[plane + e];
        v_r[q] = BWD ? xs[2 * plane + e] : 0.f;
        v_i[q] = BWD ? xs[3 * plane + e] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int rr = row0 + a < gr ? row0 + a : gr - 1;
        const float m_r = ms_r[rr * RS + k], m_i = ms_i[rr * RS + k];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          if (!BWD) {  // y = M x
            a_r[a][q] += m_r * u_r[q] - m_i * u_i[q];
            a_i[a][q] += m_r * u_i[q] + m_i * u_r[q];
          } else {  // x = conj(M)^T y, c' = M^T c (m = M[k][row])
            a_r[a][q] += m_r * u_r[q] + m_i * u_i[q];
            a_i[a][q] += m_r * u_i[q] - m_i * u_r[q];
            b_r[a][q] += m_r * v_r[q] - m_i * v_i[q];
            b_i[a][q] += m_r * v_i[q] + m_i * v_r[q];
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (row0 + a >= gr) continue;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const long off = base + (g0 + row0 + a) * C + lane + 32 * q;
        o1r[off] = a_r[a][q];
        o1i[off] = a_i[a][q];
        if (BWD) {
          o2r[off] = b_r[a][q];
          o2i[off] = b_i[a][q];
        }
      }
    }
  }
}

template <bool BWD>
cudaError_t rowm_apply(const float* i1r, const float* i1i, const float* i2r,
                       const float* i2i, float* o1r, float* o1i, float* o2r,
                       float* o2i, const float* mr, const float* mi, int r,
                       int nkernel, int rmx, cudaStream_t st) {
  constexpr int CW = BWD ? 32 : 64;
  constexpr int NP = BWD ? 4 : 2;
  const int R = 1 << rmx;
  const int lc = nkernel - rmx + 7;  // log2 of a block matrix's columns
  const size_t smem = sizeof(float) * (static_cast<size_t>(NP) * R * CW +
                                       2 * RM_GROUP * static_cast<size_t>(R + 1));
  cudaError_t err = cudaFuncSetAttribute(
      rowm_apply_kernel<BWD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long grid = static_cast<long>(r >> nkernel) * ((1L << lc) / CW);
  rowm_apply_kernel<BWD><<<static_cast<unsigned>(grid), THREADS, smem, st>>>(
      i1r, i1i, i2r, i2i, o1r, o1i, o2r, o2i, mr, mi, rmx, lc);
  return cudaGetLastError();
}

// Columns of one dM7 partial: the sum over all blocks runs over
// K = r * 128 / R columns, in at most 64 chunks of at least 256.
long rowm_dm_chunk(int r, int rmx) {
  const long k = (static_cast<long>(r) * LANES) >> rmx;
  long kc = k >> 6;
  if (kc < 256) kc = 256;
  return kc < k ? kc : k;
}

// Floats of the dM7 partials.
size_t rowm_dm_floats(int r, int rmx) {
  const long k = (static_cast<long>(r) * LANES) >> rmx;
  return static_cast<size_t>(k / rowm_dm_chunk(r, rmx)) * 2 << (2 * rmx);
}

// part[blockIdx.y] (2, R, R) planes, the 32 x 32 tile of blockIdx.x: the
// sum over the chunk's kc columns g of c[i][g] * x[j][g], the
// non-conjugating product; column g of the whole state is column g % C of
// block g / C.
__global__ void __launch_bounds__(THREADS)
rowm_dm_kernel(const float* cr, const float* ci, const float* xr,
               const float* xi, float* part, int lr, int lc, long kc) {
  __shared__ float cs_r[RD_T][RD_KS + 1], cs_i[RD_T][RD_KS + 1];
  __shared__ float xs_r[RD_T][RD_KS + 1], xs_i[RD_T][RD_KS + 1];
  const int R = 1 << lr;
  const int t = R < RD_T ? R : RD_T;
  const int tiles = R / t;
  const int i0 = (blockIdx.x / tiles) * t;
  const int j0 = (blockIdx.x % tiles) * t;
  const long C = 1L << lc;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float acc_r[4] = {0.f, 0.f, 0.f, 0.f}, acc_i[4] = {0.f, 0.f, 0.f, 0.f};
  const long g_end = (blockIdx.y + 1) * kc;
  for (long g0 = blockIdx.y * kc; g0 < g_end; g0 += RD_KS) {
    // RD_KS consecutive columns stay inside one block (C >= 128)
    const long col = ((g0 >> lc) << lr) * C + (g0 & (C - 1));
    __syncthreads();  // the previous columns are consumed
    for (int e = threadIdx.x; e < RD_T * RD_KS; e += THREADS) {
      const int row = e / RD_KS, kk = e % RD_KS;
      const bool in = row < t;
      cs_r[row][kk] = in ? cr[col + (i0 + row) * C + kk] : 0.f;
      cs_i[row][kk] = in ? ci[col + (i0 + row) * C + kk] : 0.f;
      xs_r[row][kk] = in ? xr[col + (j0 + row) * C + kk] : 0.f;
      xs_i[row][kk] = in ? xi[col + (j0 + row) * C + kk] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < RD_KS; ++kk) {
      const float x_r = xs_r[lane][kk], x_i = xs_i[lane][kk];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float c_r = cs_r[warp * 4 + a][kk], c_i = cs_i[warp * 4 + a][kk];
        acc_r[a] += c_r * x_r - c_i * x_i;
        acc_i[a] += c_r * x_i + c_i * x_r;
      }
    }
  }
  if (lane >= t) return;
  const long rr = static_cast<long>(R) * R;
  float* out = part + blockIdx.y * 2 * rr;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = warp * 4 + a;
    if (i >= t) continue;
    out[(i0 + i) * static_cast<long>(R) + j0 + lane] = acc_r[a];
    out[rr + (i0 + i) * static_cast<long>(R) + j0 + lane] = acc_i[a];
  }
}

// dm7 (2, R, R) <- sum over all blocks of c x^T; part holds rowm_dm_floats.
cudaError_t rowm_dm(const float* cr, const float* ci, const float* xr,
                    const float* xi, float* part, float* dm7, int r,
                    int nkernel, int rmx, cudaStream_t st) {
  const int R = 1 << rmx;
  const int t = R < RD_T ? R : RD_T;
  const long kc = rowm_dm_chunk(r, rmx);
  const long nc = ((static_cast<long>(r) * LANES) >> rmx) / kc;
  rowm_dm_kernel<<<dim3((R / t) * (R / t), static_cast<unsigned>(nc)), THREADS, 0, st>>>(
      cr, ci, xr, xi, part, rmx, nkernel - rmx + 7, kc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int w = 2 * R * R;
  return colsum(part, static_cast<int>(nc), w, dm7, w, 0, st);
}

}  // namespace
