// Lane-matrix stages shared by the forward and backward kernels of the
// port (zzrx_fwd.cu, zzrx_bwd.cu, row_layer.cu), on the (r, 128) float32
// plane pair of a complex64 statevector.  Layout index = row * 128 + lane.
// The whole-block kernels (multilayer.cu) take W = 128-1024 lanes and have
// width-generic stages of their own; they share the helpers here (the
// deterministic block sum, 16-byte cp.async copies, float vectors, colsum).
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

// 16-byte asynchronous copies (cp.async.cg) and 2- or 4-float vectors.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N consecutive floats (N = 2 or 4, aligned) between memory and registers
template <int N>
__device__ __forceinline__ void vload(const float* p, float* v) {
  static_assert(N == 2 || N == 4, "vload: 2 or 4 floats");
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  }
}

template <int N>
__device__ __forceinline__ void vstore(float* p, const float* v) {
  static_assert(N == 2 || N == 4, "vstore: 2 or 4 floats");
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Sum of v over the warp, in every lane (a fixed xor tree).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum of v over the block, valid in thread 0: a warp xor-butterfly, then
// the warp sums in order (a fixed order, so the result is reproducible).
// Every thread must call it; it contains two barriers.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
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

}  // namespace
