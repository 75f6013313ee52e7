// The helpers every kernel source shares, on the (r, 128) float32 plane
// pair of a complex64 statevector.  Layout index = row * 128 + lane: the
// deterministic block sum, 16-byte cp.async copies, float vectors,
// colsum_kernel (per-CTA partials added in a fixed order).  The kernels'
// lane products and row stages (K1-K4, K6-K12, K15) are in
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
