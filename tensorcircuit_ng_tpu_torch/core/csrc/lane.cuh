// Lane-matrix stages shared by the forward and backward kernels of the
// port (zzrx_fwd.cu, zzrx_bwd.cu, row_layer.cu), on the (r, 128) float32
// plane pair of a complex64 statevector.  Layout index = row * 128 + lane.
// The whole-block kernels (multilayer.cu) take W = 128-1024 lanes and have
// width-generic stages of their own at the end of this file.
//
//   lane_outer_kernel: y = x @ M on 32-row tiles, M streamed through
//     shared memory in K chunks (and, for the grand forward, the outer
//     (D, D) left-matmul across the D rows {i + k*RB} a CTA holds);
//   lane_bwd_kernel: psi = y @ conj(M)^T and w = ct @ M^T on 16-row tiles;
//   dm_partial_kernel + colsum_kernel: dM = psi^T ct (the non-conjugating
//     product) as one partial a row chunk, added in a fixed order.
// Sums across CTAs use no atomics, so two runs give the same result bit
// for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int MM = LANES * LANES;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
// forward lane pass: 32 rows a CTA, 8 warps x 4 rows, 4 columns a thread
constexpr int B_ROWS = 32;
constexpr int B_KC = 8;
// backward lane pass: 16 rows a CTA, 8 warps x 2 rows, 4 columns a thread
constexpr int L_ROWS = 16;
constexpr int KC = 8;
// dM pass: 32 rows of dM (8 warps x 4) a CTA
constexpr int DM_SLAB = 32;

int ilog2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

// Sum of v over the block, valid in thread 0: a warp xor-butterfly, then
// the warp sums in order (a fixed order, so the result is reproducible).
// Every thread must call it; it contains two barriers.
__device__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < NWARPS; ++w) t += red[w];
  __syncthreads();
  return t;
}

// Rows of a forward lane tile: local row lr holds global row
// (blockIdx.x * ni + lr / d) + (lr % d) * rb, so that with d > 1 the d
// rows one outer matrix mixes sit in one CTA (d = 1: contiguous rows).
__device__ __forceinline__ long b_row(int lr, int ni, int d, int rb) {
  return static_cast<long>(blockIdx.x) * ni + lr / d +
         static_cast<long>(lr % d) * rb;
}

template <bool OUTER>
__global__ void __launch_bounds__(THREADS)
lane_outer_kernel(const float* xr, const float* xi, float* yr, float* yi,
                  float* ksr, float* ksi, const float* __restrict__ mr,
                  const float* __restrict__ mi, const float* __restrict__ mor,
                  const float* __restrict__ moi, int ni, int d, int rb) {
  __shared__ float xs_r[B_ROWS][LANES];
  __shared__ float xs_i[B_ROWS][LANES];
  __shared__ float ms_r[B_KC][LANES];
  __shared__ float ms_i[B_KC][LANES];
  const int tr_rows = ni * d;
  for (int e = threadIdx.x; e < tr_rows * LANES; e += blockDim.x) {
    const int lr = e / LANES, c = e % LANES;
    const long off = b_row(lr, ni, d, rb) * LANES + c;
    xs_r[lr][c] = xr[off];
    xs_i[lr][c] = xi[off];
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float acc_r[4][4], acc_i[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc_r[a][q] = acc_i[a][q] = 0.f;
  for (int kc = 0; kc < LANES; kc += B_KC) {
    __syncthreads();  // tile loaded / previous chunk consumed
    for (int e = threadIdx.x; e < B_KC * LANES; e += blockDim.x) {
      ms_r[e / LANES][e % LANES] = mr[(kc + e / LANES) * LANES + e % LANES];
      ms_i[e / LANES][e % LANES] = mi[(kc + e / LANES) * LANES + e % LANES];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < B_KC; ++kk) {
      float m_r[4], m_i[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        m_r[q] = ms_r[kk][lane + 32 * q];
        m_i[q] = ms_i[kk][lane + 32 * q];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float x_r = xs_r[warp * 4 + a][kc + kk];
        const float x_i = xs_i[warp * 4 + a][kc + kk];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc_r[a][q] += x_r * m_r[q] - x_i * m_i[q];
          acc_i[a][q] += x_r * m_i[q] + x_i * m_r[q];
        }
      }
    }
  }
  if (!OUTER) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int lr = warp * 4 + a;
      if (lr >= tr_rows) continue;
      const long base = b_row(lr, ni, d, rb) * LANES;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        yr[base + lane + 32 * q] = acc_r[a][q];
        yi[base + lane + 32 * q] = acc_i[a][q];
      }
    }
    return;
  }
  __syncthreads();  // every thread is done reading the x tile
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int lr = warp * 4 + a;
    if (lr >= tr_rows) continue;
    const long base = b_row(lr, ni, d, rb) * LANES;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = lane + 32 * q;
      ksr[base + c] = acc_r[a][q];
      ksi[base + c] = acc_i[a][q];
      xs_r[lr][c] = acc_r[a][q];
      xs_i[lr][c] = acc_i[a][q];
    }
  }
  __syncthreads();
  // outer: row (i, k) <- sum_k' mo[k][k'] * row (i, k')
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int lr = warp * 4 + a;
    if (lr >= tr_rows) continue;
    const int k = lr % d;
    const int g0 = lr - k;
    float o_r[4] = {0.f, 0.f, 0.f, 0.f}, o_i[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kp = 0; kp < d; ++kp) {
      const float wr = mor[k * d + kp], wi = moi[k * d + kp];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v_r = xs_r[g0 + kp][lane + 32 * q];
        const float v_i = xs_i[g0 + kp][lane + 32 * q];
        o_r[q] += wr * v_r - wi * v_i;
        o_i[q] += wr * v_i + wi * v_r;
      }
    }
    const long base = b_row(lr, ni, d, rb) * LANES;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      yr[base + lane + 32 * q] = o_r[q];
      yi[base + lane + 32 * q] = o_i[q];
    }
  }
}

// y = x @ M on whole rows, in place allowed (a CTA loads its tile before it
// writes, and tiles are disjoint).
cudaError_t lane_fwd_stage(const float* xr, const float* xi, float* yr,
                           float* yi, const float* mr, const float* mi, int r,
                           cudaStream_t s) {
  const int ni = r < B_ROWS ? r : B_ROWS;
  lane_outer_kernel<false><<<r / ni, THREADS, 0, s>>>(
      xr, xi, yr, yi, nullptr, nullptr, mr, mi, nullptr, nullptr, ni, 1, r);
  return cudaGetLastError();
}

// psi = y @ conj(M)^T and w = ct @ M^T on 16-row tiles.
__global__ void __launch_bounds__(THREADS)
lane_bwd_kernel(const float* yr, const float* yi, const float* cr,
                const float* ci, float* pr, float* pi, float* wr, float* wi,
                const float* __restrict__ mr, const float* __restrict__ mi,
                int ni) {
  __shared__ float ys_r[L_ROWS][LANES], ys_i[L_ROWS][LANES];
  __shared__ float cs_r[L_ROWS][LANES], cs_i[L_ROWS][LANES];
  __shared__ float ms_r[KC][LANES + 1], ms_i[KC][LANES + 1];
  const long row0 = static_cast<long>(blockIdx.x) * ni;
  for (int e = threadIdx.x; e < ni * LANES; e += THREADS) {
    const int lr = e / LANES, c = e % LANES;
    const long off = (row0 + lr) * LANES + c;
    ys_r[lr][c] = yr[off];
    ys_i[lr][c] = yi[off];
    cs_r[lr][c] = cr[off];
    cs_i[lr][c] = ci[off];
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float p_r[2][4], p_i[2][4], w_r[2][4], w_i[2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) p_r[a][q] = p_i[a][q] = w_r[a][q] = w_i[a][q] = 0.f;
  for (int kc = 0; kc < LANES; kc += KC) {
    __syncthreads();  // tiles loaded / previous chunk consumed
    // ms[kk][c] = M[c][kc + kk]: the chunk of M^T
    for (int e = threadIdx.x; e < KC * LANES; e += THREADS) {
      const int c = e / KC, kk = e % KC;
      ms_r[kk][c] = mr[c * LANES + kc + kk];
      ms_i[kk][c] = mi[c * LANES + kc + kk];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      float m_r[4], m_i[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        m_r[q] = ms_r[kk][lane + 32 * q];
        m_i[q] = ms_i[kk][lane + 32 * q];
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int lr = warp * 2 + a;  // rows >= ni read unused smem
        const float y_r = ys_r[lr][kc + kk], y_i = ys_i[lr][kc + kk];
        const float c_r = cs_r[lr][kc + kk], c_i = cs_i[lr][kc + kk];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          p_r[a][q] += y_r * m_r[q] + y_i * m_i[q];
          p_i[a][q] += y_i * m_r[q] - y_r * m_i[q];
          w_r[a][q] += c_r * m_r[q] - c_i * m_i[q];
          w_i[a][q] += c_r * m_i[q] + c_i * m_r[q];
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int lr = warp * 2 + a;
    if (lr >= ni) continue;
    const long base = (row0 + lr) * LANES;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = lane + 32 * q;
      pr[base + c] = p_r[a][q];
      pi[base + c] = p_i[a][q];
      wr[base + c] = w_r[a][q];
      wi[base + c] = w_i[a][q];
    }
  }
}

// part[chunk] = (re, im) of sum over the chunk's rows of psi[row]^T ct[row]
// for the dM rows [32 * blockIdx.x, +32): the non-conjugating product.
__global__ void __launch_bounds__(THREADS)
dm_partial_kernel(const float* pr, const float* pi, const float* cr,
                  const float* ci, float* part, int ch) {
  __shared__ float ps_r[KC][DM_SLAB], ps_i[KC][DM_SLAB];
  __shared__ float cs_r[KC][LANES], cs_i[KC][LANES];
  const int a0 = blockIdx.x * DM_SLAB;
  const long row0 = static_cast<long>(blockIdx.y) * ch;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float acc_r[4][4], acc_i[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc_r[a][q] = acc_i[a][q] = 0.f;
  for (int k0 = 0; k0 < ch; k0 += KC) {
    const int kn = ch - k0 < KC ? ch - k0 : KC;
    __syncthreads();
    for (int e = threadIdx.x; e < KC * DM_SLAB; e += THREADS) {
      const int kk = e / DM_SLAB, a = e % DM_SLAB;
      const long off = (row0 + k0 + kk) * LANES + a0 + a;
      ps_r[kk][a] = kk < kn ? pr[off] : 0.f;
      ps_i[kk][a] = kk < kn ? pi[off] : 0.f;
    }
    for (int e = threadIdx.x; e < KC * LANES; e += THREADS) {
      const int kk = e / LANES, b = e % LANES;
      const long off = (row0 + k0 + kk) * LANES + b;
      cs_r[kk][b] = kk < kn ? cr[off] : 0.f;
      cs_i[kk][b] = kk < kn ? ci[off] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      float c_r[4], c_i[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        c_r[q] = cs_r[kk][lane + 32 * q];
        c_i[q] = cs_i[kk][lane + 32 * q];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p_r = ps_r[kk][warp * 4 + a], p_i = ps_i[kk][warp * 4 + a];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc_r[a][q] += p_r * c_r[q] - p_i * c_i[q];
          acc_i[a][q] += p_r * c_i[q] + p_i * c_r[q];
        }
      }
    }
  }
  float* out = part + static_cast<long>(blockIdx.y) * 2 * MM;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = a0 + warp * 4 + a;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      out[row * LANES + lane + 32 * q] = acc_r[a][q];
      out[MM + row * LANES + lane + 32 * q] = acc_i[a][q];
    }
  }
}

// out[(j / inner) * ostride + j % inner] = sum over b < nb, in order, of
// part[b * ncols + j].
__global__ void colsum_kernel(const float* part, int nb, int ncols, float* out,
                              int inner, long ostride) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ncols) return;
  float s = 0.f;
  for (int b = 0; b < nb; ++b) s += part[static_cast<long>(b) * ncols + j];
  out[static_cast<long>(j / inner) * ostride + j % inner] = s;
}

cudaError_t colsum(const float* part, int nb, int ncols, float* out, int inner,
                   long ostride, cudaStream_t st) {
  colsum_kernel<<<(ncols + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      part, nb, ncols, out, inner, ostride);
  return cudaGetLastError();
}

// Rows of one dM partial: at most 256, and at most 32 partials.
int dm_chunk(int r) {
  int ch = r < 256 ? r : 256;
  if (ch < r / 32) ch = r / 32;
  return ch;
}

// Floats of the dM partials for r rows.
size_t dm_partial_floats(int r) {
  return static_cast<size_t>(r / dm_chunk(r)) * 2 * MM;
}

// Lane stage of an adjoint: (pr, pi) <- y @ conj(M)^T, (wr, wi) <- ct @ M^T,
// dm planes (dm_out, dm_out + dm_stride) <- psi^T ct; part_dm holds
// dm_partial_floats(r) floats.
cudaError_t lane_bwd_stage(int r, const float* yr, const float* yi,
                           const float* ctr, const float* cti, const float* mr,
                           const float* mi, float* pr, float* pi, float* wr,
                           float* wi, float* part_dm, float* dm_out,
                           long dm_stride, cudaStream_t st) {
  const int ni = r < L_ROWS ? r : L_ROWS;
  lane_bwd_kernel<<<r / ni, THREADS, 0, st>>>(yr, yi, ctr, cti, pr, pi, wr,
                                              wi, mr, mi, ni);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int ch = dm_chunk(r);
  const int nchunks = r / ch;
  dm_partial_kernel<<<dim3(LANES / DM_SLAB, nchunks), THREADS, 0, st>>>(
      pr, pi, ctr, cti, part_dm, ch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return colsum(part_dm, nchunks, 2 * MM, dm_out, MM, dm_stride, st);
}

// ---------------------------------------------------------------------------
// Width-generic lane stages (the whole-block kernels of multilayer.cu): the
// (rows, W) plane pair with W = 2^lw lanes, 128 <= W <= 1024, and (W, W)
// matrices.  A CTA computes a 32 x 128 tile of the output, 8 warps x 4 rows
// and 4 columns a thread; both operands are streamed through shared memory
// in chunks of 16 along the summed axis.
// ---------------------------------------------------------------------------

constexpr int W_BM = 32;
constexpr int W_BN = 128;
constexpr int W_KC = 16;

// c = a @ op(b) on (rows, W) planes: op(b) = b (OP 0), b^T (OP 1) or
// conj(b)^T (OP 2).  c must not alias a (the column tiles of a row read all
// of a's row).
template <int OP>
__global__ void __launch_bounds__(THREADS)
wide_lane_kernel(const float* ar, const float* ai, float* cr, float* ci,
                 const float* __restrict__ br, const float* __restrict__ bi,
                 int rows, int lw) {
  __shared__ float as_r[W_KC][W_BM + 1], as_i[W_KC][W_BM + 1];
  __shared__ float bs_r[W_KC][W_BN + 1], bs_i[W_KC][W_BN + 1];
  const int w = 1 << lw;
  const long row0 = static_cast<long>(blockIdx.x) * W_BM;
  const int col0 = blockIdx.y * W_BN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float acc_r[4][4], acc_i[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc_r[a][q] = acc_i[a][q] = 0.f;
  for (int k0 = 0; k0 < w; k0 += W_KC) {
    __syncthreads();  // the previous chunk is consumed
    for (int e = threadIdx.x; e < W_BM * W_KC; e += THREADS) {
      const int m = e / W_KC, kk = e % W_KC;
      const bool in = row0 + m < rows;
      const long off = ((row0 + m) << lw) + k0 + kk;
      as_r[kk][m] = in ? ar[off] : 0.f;
      as_i[kk][m] = in ? ai[off] : 0.f;
    }
    for (int e = threadIdx.x; e < W_BN * W_KC; e += THREADS) {
      int c, kk;
      long off;
      if (OP == 0) {  // b[k0 + kk][col0 + c], c fastest
        kk = e / W_BN;
        c = e % W_BN;
        off = (static_cast<long>(k0 + kk) << lw) + col0 + c;
      } else {  // b[col0 + c][k0 + kk], kk fastest
        c = e / W_KC;
        kk = e % W_KC;
        off = (static_cast<long>(col0 + c) << lw) + k0 + kk;
      }
      bs_r[kk][c] = br[off];
      bs_i[kk][c] = OP == 2 ? -bi[off] : bi[off];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < W_KC; ++kk) {
      float m_r[4], m_i[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        m_r[q] = bs_r[kk][lane + 32 * q];
        m_i[q] = bs_i[kk][lane + 32 * q];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float x_r = as_r[kk][warp * 4 + a], x_i = as_i[kk][warp * 4 + a];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc_r[a][q] += x_r * m_r[q] - x_i * m_i[q];
          acc_i[a][q] += x_r * m_i[q] + x_i * m_r[q];
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const long row = row0 + warp * 4 + a;
    if (row >= rows) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long off = (row << lw) + col0 + lane + 32 * q;
      cr[off] = acc_r[a][q];
      ci[off] = acc_i[a][q];
    }
  }
}

template <int OP>
cudaError_t wide_lane(const float* ar, const float* ai, float* cr, float* ci,
                      const float* br, const float* bi, int rows, int lw,
                      cudaStream_t st) {
  const dim3 grid((rows + W_BM - 1) / W_BM, (1 << lw) / W_BN);
  wide_lane_kernel<OP><<<grid, THREADS, 0, st>>>(ar, ai, cr, ci, br, bi, rows, lw);
  return cudaGetLastError();
}

// part[blockIdx.y] (2, W, W) planes, the 32 x 128 tile of blockIdx.x: the
// sum over the chunk's ch rows of p[row][a] * c[row][b], the
// non-conjugating product p^T c.
__global__ void __launch_bounds__(THREADS)
wide_dm_kernel(const float* pr, const float* pi, const float* cr,
               const float* ci, float* part, int ch, int lw) {
  __shared__ float ps_r[W_KC][W_BM], ps_i[W_KC][W_BM];
  __shared__ float cs_r[W_KC][W_BN], cs_i[W_KC][W_BN];
  const int w = 1 << lw;
  const int tiles_b = w / W_BN;
  const int a0 = (blockIdx.x / tiles_b) * W_BM;
  const int b0 = (blockIdx.x % tiles_b) * W_BN;
  const long row0 = static_cast<long>(blockIdx.y) * ch;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float acc_r[4][4], acc_i[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc_r[a][q] = acc_i[a][q] = 0.f;
  for (int k0 = 0; k0 < ch; k0 += W_KC) {
    const int kn = ch - k0 < W_KC ? ch - k0 : W_KC;
    __syncthreads();
    for (int e = threadIdx.x; e < W_KC * W_BM; e += THREADS) {
      const int kk = e / W_BM, a = e % W_BM;
      const long off = ((row0 + k0 + kk) << lw) + a0 + a;
      ps_r[kk][a] = kk < kn ? pr[off] : 0.f;
      ps_i[kk][a] = kk < kn ? pi[off] : 0.f;
    }
    for (int e = threadIdx.x; e < W_KC * W_BN; e += THREADS) {
      const int kk = e / W_BN, b = e % W_BN;
      const long off = ((row0 + k0 + kk) << lw) + b0 + b;
      cs_r[kk][b] = kk < kn ? cr[off] : 0.f;
      cs_i[kk][b] = kk < kn ? ci[off] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < W_KC; ++kk) {
      float c_r[4], c_i[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        c_r[q] = cs_r[kk][lane + 32 * q];
        c_i[q] = cs_i[kk][lane + 32 * q];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p_r = ps_r[kk][warp * 4 + a], p_i = ps_i[kk][warp * 4 + a];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc_r[a][q] += p_r * c_r[q] - p_i * c_i[q];
          acc_i[a][q] += p_r * c_i[q] + p_i * c_r[q];
        }
      }
    }
  }
  const long ww = static_cast<long>(w) * w;
  float* out = part + static_cast<long>(blockIdx.y) * 2 * ww;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const long row = a0 + warp * 4 + a;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      out[(row << lw) + b0 + lane + 32 * q] = acc_r[a][q];
      out[ww + (row << lw) + b0 + lane + 32 * q] = acc_i[a][q];
    }
  }
}

// Row chunks of the dM partials for (rows, W): about 1024 CTAs, at most 16
// partials, at least 16 rows a chunk where there are that many (powers of
// two, so the chunks divide rows).
int wide_dm_chunks(int rows, int lw) {
  const int tiles = ((1 << lw) / W_BM) * ((1 << lw) / W_BN);
  int nc = 1024 / tiles;
  if (nc > 16) nc = 16;
  if (nc > rows / W_KC) nc = rows / W_KC;
  return nc < 1 ? 1 : nc;
}

// Floats of the dM partials for (rows, W).
size_t wide_dm_floats(int rows, int lw) {
  return static_cast<size_t>(wide_dm_chunks(rows, lw)) * 2 << (2 * lw);
}

// dm planes (dm_out, dm_out + dm_stride) <- p^T c over all rows, as
// per-chunk partials added in a fixed order; part holds wide_dm_floats.
cudaError_t wide_dm(const float* pr, const float* pi, const float* cr,
                    const float* ci, float* part, float* dm_out, long dm_stride,
                    int rows, int lw, cudaStream_t st) {
  const int nc = wide_dm_chunks(rows, lw);
  const int tiles = ((1 << lw) / W_BM) * ((1 << lw) / W_BN);
  wide_dm_kernel<<<dim3(tiles, nc), THREADS, 0, st>>>(pr, pi, cr, ci, part, rows / nc, lw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long ww = 1L << (2 * lw);
  return colsum(part, nc, static_cast<int>(2 * ww), dm_out, static_cast<int>(ww), dm_stride, st);
}

}  // namespace
