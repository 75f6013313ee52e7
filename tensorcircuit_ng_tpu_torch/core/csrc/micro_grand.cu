// K15 tcng_micro_grand for Hopper (sm_90a): the staged micro-benchmark of
// K2's design.  Replaces examples/micro_grand_fusion.py run_micro
// (_micro_kernel) at its shapes: L layers over a ping-pong pair of (r, 128)
// float32 planes, r = D * RB with RB = 1024 rows a block (10 row qubits)
// and D blocks (n = 20: D = 8).  Layout index = row * 128 + lane.
//
//   level 1 (m1): each layer copies the state to the other buffer;
//   level 2 (m2): each layer applies the 10 raw-(c, s) butterflies
//     [[c, -i s], [-i s, c]] to each block's rows, (c, s) = cs[l][q] on the
//     in-block row bit of stride RB >> (q + 1), then the lane product
//     y = x @ (mlr[l] + i mli[l]);
//   level 3 (m3): m2, then at the end of each layer the (D, D) complex
//     left-matmul by mo[l] across the D blocks.
// Layer l reads the input (l = 0) or the buffer layer l - 1 wrote, and
// writes the output when L - 1 - l is even, else the scratch pair: the
// output holds the last layer (for even L the TPU kernel's parity: scratch
// on even layers, the output on odd ones).  The inputs need not be unitary.
//
// Design.  The TPU kernel keeps the whole state in VMEM across its (L, D)
// grid; a CTA has 227 KB, so here each layer is passes over the state,
// which stays in the 50 MB L2 at n = 20 (16.8 MB for both buffers):
//   copy pass (m1): float4 loads and stores;
//   butterfly pass (m2, m3): a CTA holds all RB rows of a block for 8 lanes
//     (64 KB of planes, as K1's pass A) and runs the 10 butterflies in
//     place in shared memory, reading src and writing dst;
//   lane pass: lane.cuh's y = x @ M, in place;
//   outer pass (m3): one thread per in-block position holds its D elements
//     in registers, in place.
// One C entry point launches the passes layer by layer on the caller's
// stream.  Bound: m1 bytes (the state read and written each layer), m2 and
// m3 operations (the lane product, 8 * 128 flops an amplitude a layer).

#include "lane.cuh"

namespace {

constexpr int RB = 1024;
constexpr int NBF = 10;                     // butterflies: log2(RB)
constexpr int MG_TL = 8;                    // lanes a butterfly tile
constexpr int MG_ELEMS = RB * MG_TL;        // 64 KB of planes
constexpr int MAX_D = 16;

__global__ void __launch_bounds__(THREADS)
copy_kernel(const float4* xr, const float4* xi, float4* yr, float4* yi, long n4) {
  for (long e = blockIdx.x * static_cast<long>(THREADS) + threadIdx.x; e < n4;
       e += static_cast<long>(gridDim.x) * THREADS) {
    yr[e] = xr[e];
    yi[e] = xi[e];
  }
}

// The NBF butterflies with raw (c, s) = cs[q] on an RB x MG_TL tile.
__global__ void __launch_bounds__(THREADS)
butterfly_kernel(const float* xr, const float* xi, float* yr, float* yi,
                 const float* __restrict__ cs) {
  extern __shared__ float smem[];
  float* tr = smem;
  float* ti = smem + MG_ELEMS;
  constexpr int LTL = 3;  // log2(MG_TL)
  const long j = blockIdx.x / (LANES / MG_TL);  // row block
  const int lane0 = (blockIdx.x % (LANES / MG_TL)) * MG_TL;
  for (int e = threadIdx.x; e < MG_ELEMS; e += THREADS) {
    const long off = (j * RB + (e >> LTL)) * LANES + lane0 + (e & (MG_TL - 1));
    tr[e] = xr[off];
    ti[e] = xi[off];
  }
  __syncthreads();
  for (int q = 0; q < NBF; ++q) {
    const int ls = NBF - 1 - q;  // log2 of the row stride
    const float c = cs[2 * q], sn = cs[2 * q + 1];
    for (int p = threadIdx.x; p < MG_ELEMS / 2; p += THREADS) {
      const int pr = p >> LTL;
      const int l = p & (MG_TL - 1);
      const int lo = ((pr >> ls) << (ls + 1)) | (pr & ((1 << ls) - 1));
      const int elo = (lo << LTL) | l;
      const int ehi = elo + (1 << (ls + LTL));
      const float ar = tr[elo], ai = ti[elo], br = tr[ehi], bi = ti[ehi];
      tr[elo] = c * ar + sn * bi;
      ti[elo] = c * ai - sn * br;
      tr[ehi] = c * br + sn * ai;
      ti[ehi] = c * bi - sn * ar;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < MG_ELEMS; e += THREADS) {
    const long off = (j * RB + (e >> LTL)) * LANES + lane0 + (e & (MG_TL - 1));
    yr[off] = tr[e];
    yi[off] = ti[e];
  }
}

// x[m] <- sum_k mo[m][k] x[k] over the D blocks, at in-block position p.
template <int D>
__global__ void __launch_bounds__(THREADS)
outer_fwd_kernel(float* xr, float* xi, const float* __restrict__ mor,
                 const float* __restrict__ moi) {
  __shared__ float m_r[D * D], m_i[D * D];
  for (int e = threadIdx.x; e < D * D; e += THREADS) {
    m_r[e] = mor[e];
    m_i[e] = moi[e];
  }
  __syncthreads();
  constexpr long BE = static_cast<long>(RB) * LANES;
  const long p = static_cast<long>(blockIdx.x) * THREADS + threadIdx.x;
  float v_r[D], v_i[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    v_r[k] = xr[k * BE + p];
    v_i[k] = xi[k * BE + p];
  }
#pragma unroll
  for (int m = 0; m < D; ++m) {
    float s_r = 0.f, s_i = 0.f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      s_r += m_r[m * D + k] * v_r[k] - m_i[m * D + k] * v_i[k];
      s_i += m_r[m * D + k] * v_i[k] + m_i[m * D + k] * v_r[k];
    }
    xr[m * BE + p] = s_r;
    xi[m * BE + p] = s_i;
  }
}

cudaError_t outer_fwd(int d, float* xr, float* xi, const float* mor,
                      const float* moi, cudaStream_t st) {
  const int grid = RB * LANES / THREADS;
  switch (d) {
    case 2: outer_fwd_kernel<2><<<grid, THREADS, 0, st>>>(xr, xi, mor, moi); break;
    case 4: outer_fwd_kernel<4><<<grid, THREADS, 0, st>>>(xr, xi, mor, moi); break;
    case 8: outer_fwd_kernel<8><<<grid, THREADS, 0, st>>>(xr, xi, mor, moi); break;
    case 16: outer_fwd_kernel<16><<<grid, THREADS, 0, st>>>(xr, xi, mor, moi); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tcng_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K15.  level 1, 2 or 3; cs (L, 10, 2); mlr/mli (L, 128, 128); mor/moi
// (L, D, D) with D = r / 1024 in {2, 4, 8, 16} (level 3 only); sr/si (r,
// 128) input planes; yr/yi (r, 128) output planes; ar/ai (r, 128)
// scratch planes.  Returns the first CUDA error, 0 on success.
int tcng_micro_grand(int level, const float* cs, const float* mlr,
                     const float* mli, const float* mor, const float* moi,
                     const float* sr, const float* si, float* yr, float* yi,
                     float* ar, float* ai, int L, int r, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int d = r / RB;
  if (level < 1 || level > 3 || r % RB || d < 1 || d > MAX_D)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if (level >= 2) {
    err = cudaFuncSetAttribute(butterfly_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               2 * MG_ELEMS * static_cast<int>(sizeof(float)));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long plane = static_cast<long>(r) * LANES;
  const float *xr = sr, *xi = si;
  for (int l = 0; l < L; ++l) {
    const bool to_out = (L - 1 - l) % 2 == 0;
    float* dr = to_out ? yr : ar;
    float* di = to_out ? yi : ai;
    if (level == 1) {
      copy_kernel<<<static_cast<unsigned>((plane / 4 + THREADS - 1) / THREADS), THREADS, 0, st>>>(
          reinterpret_cast<const float4*>(xr), reinterpret_cast<const float4*>(xi),
          reinterpret_cast<float4*>(dr), reinterpret_cast<float4*>(di), plane / 4);
      err = cudaGetLastError();
    } else {
      butterfly_kernel<<<d * (LANES / MG_TL), THREADS, 2 * MG_ELEMS * sizeof(float), st>>>(
          xr, xi, dr, di, cs + l * 2 * NBF);
      err = cudaGetLastError();
      if (err == cudaSuccess)
        err = lane_fwd_stage(dr, di, dr, di, mlr + static_cast<long>(l) * MM,
                             mli + static_cast<long>(l) * MM, r, st);
      if (err == cudaSuccess && level == 3)
        err = outer_fwd(d, dr, di, mor + l * d * d, moi + l * d * d, st);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    xr = dr;
    xi = di;
  }
  return 0;
}

}  // extern "C"
