// Lane-matrix stages of the forward kernels of the port (zzrx_fwd.cu,
// row_layer.cu) and the helpers every kernel source shares, on the (r, 128)
// float32 plane pair of a complex64 statevector.  Layout index = row * 128
// + lane.
//
//   lane_fwd_kernel: y = x @ M on 32-row tiles, M streamed through shared
//     memory in K chunks (K1, K6 and K15);
//   helpers: the deterministic block sum, 16-byte cp.async copies, float
//     vectors, colsum_kernel (per-CTA partials added in a fixed order).
// The adjoint's lane and row stages (K3, K4, K7's lane, K10) are in
// adjoint_stages.cuh.  Sums across CTAs use no atomics, so two runs give
// the same result bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int MM = LANES * LANES;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
// forward lane stage: 32 rows a CTA, 8 warps x 4 rows, 4 columns a thread
constexpr int B_ROWS = 32;
constexpr int B_KC = 8;

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

// K1's and K6's lane stage: y = x @ M on tiles of ni <= 32 consecutive
// rows, 8 warps x 4 rows, 4 columns a thread, M streamed through shared
// memory in chunks of 8 k.  x and y may alias (a CTA loads its tile before
// it writes, and tiles are disjoint).
__global__ void __launch_bounds__(THREADS)
lane_fwd_kernel(const float* xr, const float* xi, float* yr, float* yi,
                const float* __restrict__ mr, const float* __restrict__ mi, int ni) {
  __shared__ float xs_r[B_ROWS][LANES];
  __shared__ float xs_i[B_ROWS][LANES];
  __shared__ float ms_r[B_KC][LANES];
  __shared__ float ms_i[B_KC][LANES];
  const long row0 = static_cast<long>(blockIdx.x) * ni;
  for (int e = threadIdx.x; e < ni * LANES; e += blockDim.x) {
    const int lr = e / LANES, c = e % LANES;
    const long off = (row0 + lr) * LANES + c;
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
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int lr = warp * 4 + a;
    if (lr >= ni) continue;
    const long base = (row0 + lr) * LANES;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      yr[base + lane + 32 * q] = acc_r[a][q];
      yi[base + lane + 32 * q] = acc_i[a][q];
    }
  }
}

// y = x @ M on whole rows, in place allowed.
cudaError_t lane_fwd_stage(const float* xr, const float* xi, float* yr,
                           float* yi, const float* mr, const float* mi, int r,
                           cudaStream_t s) {
  const int ni = r < B_ROWS ? r : B_ROWS;
  lane_fwd_kernel<<<r / ni, THREADS, 0, s>>>(xr, xi, yr, yi, mr, mi, ni);
  return cudaGetLastError();
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

}  // namespace
