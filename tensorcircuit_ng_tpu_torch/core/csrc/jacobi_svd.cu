// K5: one-sided (Hestenes) Jacobi SVD of a batch of complex matrices for
// Hopper (sm_90a), the whole sweep loop inside the kernel.
//
// Replaces kernels_jacobi._run_kernel_lanes (the TPU production layout),
// _run_kernel_packed and _run_kernel (tensorcircuit_ng_tpu/core/
// kernels_jacobi.py): the three compute one function in three TPU layouts.
// Input: float32 (real, imag) planes (B, n, m), stored transposed, so row j
// is column j of A.  sweeps * (n-1) rounds of the Brent-Luk tournament
// (slot 0 fixed; new_top = [top0, bot0, top1..top_{h-2}], new_bot =
// [bot1..bot_{h-1}, top_{h-1}]), all h = n/2 plane rotations of a round at
// once; optionally V with the same rotations.  The arithmetic of a pair is
// the Pallas _jacobi_kernel body: the four column sums, inv_mod =
// rsqrt(mod2 + 1e-36), t = sign(tau) / (|tau| + sqrt(1 + tau^2)) with a
// three-way sign (sign(0) = 0: an exactly tied pair is not rotated that
// round), the relative skip guard mod2 <= 1e-24 app aqq, and the
// 12-multiply rotation.  A fixed sweep count, no convergence test.  Built
// without fast-math, so denormals are kept.
//
// What bounds it.  Per pair and round 36 m flops on A (16 for the four sums,
// 20 for the rotation) and 20 n on V: 17.5 GFLOP for the TEBD batch of
// B = 30 matrices of 128 x 128 at 10 sweeps, 0.26 ms at 67 TFLOP/s float32;
// bytes are negligible.  But the rounds are strictly sequential, each needs
// a sum over the column before its rotation, and one matrix is one CTA, so
// 30 matrices use 30 of 132 SMs: the kernel is bound by the latency of a
// round and the shared-memory traffic of one SM, not by the card's flops.
//
// Design.  A's two planes of one 128 x 128 matrix take 128 KB and V's
// another 128 KB: both do not fit the 227 KB of one CTA.  So two kernels:
//   jacobi_a_kernel: one CTA per matrix, A's planes in dynamic shared
//     memory; warp w takes pairs w, w + 32, ...; a lane holds EPL elements
//     of each of the pair's two columns in registers, the four sums are a
//     warp butterfly (every lane ends with the same sums, so no block-wide
//     reduction), and one __syncthreads per round.  Columns stay in place:
//     the tournament has period n-1, so the column in a slot at round r is
//     a closed form of (r mod n-1, slot) (pair_cols), and after sweeps *
//     (n-1) rounds every column is back in its own slot, the order the
//     Pallas kernel writes.  With V, lane 0 of each pair writes (c,
//     s cos phi, s sin phi) to a log in device memory: 12 B a pair and
//     round, 1 MB a matrix, resident in L2.
//   jacobi_v_kernel: replays the log on V.  Column rotations leave the rows
//     of V independent, so V^T's columns split over n / 16 CTAs a matrix,
//     each holding a (n, 16) slice in shared memory from the identity on.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int MAX_WARPS = 32;
constexpr int V_COLS = 16;
constexpr int V_THREADS = 256;
constexpr int MAX_M = 256;
constexpr size_t MAX_SMEM = 232448;
constexpr unsigned FULL = 0xffffffffu;

// the column whose starting slot is at position j of the cycle the moving
// slots follow: t1 -> t2 -> ... -> t_{h-1} -> b_{h-1} -> ... -> b0 -> t1
// (top slot t_i holds column i at round 0, bottom slot b_i column h + i)
__device__ __forceinline__ int slot_col(int j, int h, int n) {
  return j < h - 1 ? j + 1 : h + (n - 2 - j);
}

// (top, bottom) column of pair p at round r, 0 <= r < n-1
__device__ __forceinline__ int2 pair_cols(int r, int p, int h, int n) {
  const int len = n - 1;
  int kt = p - 1 - r;
  if (kt < 0) kt += len;
  int kb = n - 2 - p - r;
  if (kb < 0) kb += len;
  return make_int2(p == 0 ? 0 : slot_col(kt, h, n), slot_col(kb, h, n));
}

__device__ __forceinline__ float sign3(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// c, s cos(phi), s sin(phi) of one pair from its four column sums
__device__ __forceinline__ void rotation(float app, float aqq, float pr,
                                         float pi, float* c_out, float* scph,
                                         float* ssph) {
  // 1/sqrt correctly rounded (IEEE sqrt and division), not rsqrtf(): its
  // 2-ulp error makes c^2 + s^2 and |e^{i phi}| miss 1, and the 1,270
  // slightly non-unitary rotations of a call compound it
  const float mod2 = pr * pr + pi * pi;
  const float inv_mod = 1.f / sqrtf(mod2 + 1e-36f);
  const float cph = pr * inv_mod;
  const float sph = pi * inv_mod;
  const float tau = (aqq - app) * 0.5f * inv_mod;
  const float t = sign3(tau) / (fabsf(tau) + sqrtf(1.f + tau * tau));
  float c = 1.f / sqrtf(1.f + t * t);
  float s = c * t;
  if (mod2 <= 1e-24f * (app * aqq)) {
    c = 1.f;
    s = 0.f;
  }
  *c_out = c;
  *scph = s * cph;
  *ssph = s * sph;
}

// EPL: column elements a lane holds (m <= 32 * EPL)
template <int EPL>
__global__ void __launch_bounds__(32 * MAX_WARPS)
jacobi_a_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ oxr, float* __restrict__ oxi,
                float* __restrict__ rlog, int n, int m, int rounds) {
  extern __shared__ float smem[];
  const size_t plane = static_cast<size_t>(n) * m;
  float* ar = smem;
  float* ai = smem + plane;
  const size_t base = blockIdx.x * plane;
  for (size_t e = threadIdx.x; e < plane; e += blockDim.x) {
    ar[e] = xr[base + e];
    ai[e] = xi[base + e];
  }
  __syncthreads();
  const int h = n / 2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float* lg = rlog == nullptr
                  ? nullptr
                  : rlog + static_cast<size_t>(blockIdx.x) * rounds * 3 * h;
  int rr = 0;  // the round modulo n-1, the tournament's period
  for (int r = 0; r < rounds; ++r) {
    for (int p = warp; p < h; p += nwarps) {
      const int2 col = pair_cols(rr, p, h, n);
      float* tr = ar + col.x * m;
      float* ti = ai + col.x * m;
      float* br = ar + col.y * m;
      float* bi = ai + col.y * m;
      float xtr[EPL], xti[EPL], xbr[EPL], xbi[EPL];
      float app = 0.f, aqq = 0.f, pr = 0.f, pi = 0.f;
#pragma unroll
      for (int k = 0; k < EPL; ++k) {
        const int e = lane + 32 * k;
        const bool in = e < m;
        xtr[k] = in ? tr[e] : 0.f;
        xti[k] = in ? ti[e] : 0.f;
        xbr[k] = in ? br[e] : 0.f;
        xbi[k] = in ? bi[e] : 0.f;
        app += xtr[k] * xtr[k] + xti[k] * xti[k];
        aqq += xbr[k] * xbr[k] + xbi[k] * xbi[k];
        // a_pq = <p, q> (conjugate on p)
        pr += xtr[k] * xbr[k] + xti[k] * xbi[k];
        pi += xtr[k] * xbi[k] - xti[k] * xbr[k];
      }
      // butterfly: every lane ends with the same four sums
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        app += __shfl_xor_sync(FULL, app, o);
        aqq += __shfl_xor_sync(FULL, aqq, o);
        pr += __shfl_xor_sync(FULL, pr, o);
        pi += __shfl_xor_sync(FULL, pi, o);
      }
      float c, scph, ssph;
      rotation(app, aqq, pr, pi, &c, &scph, &ssph);
      // p' = c p - s e^{-i phi} q ;  q' = s e^{i phi} p + c q
#pragma unroll
      for (int k = 0; k < EPL; ++k) {
        const int e = lane + 32 * k;
        if (e < m) {
          tr[e] = c * xtr[k] - scph * xbr[k] - ssph * xbi[k];
          ti[e] = c * xti[k] - scph * xbi[k] + ssph * xbr[k];
          br[e] = c * xbr[k] + scph * xtr[k] - ssph * xti[k];
          bi[e] = c * xbi[k] + scph * xti[k] + ssph * xtr[k];
        }
      }
      if (lg != nullptr && lane == 0) {
        float* row = lg + static_cast<size_t>(r) * 3 * h;
        row[p] = c;
        row[h + p] = scph;
        row[2 * h + p] = ssph;
      }
    }
    __syncthreads();
    if (++rr == n - 1) rr = 0;
  }
  for (size_t e = threadIdx.x; e < plane; e += blockDim.x) {
    oxr[base + e] = ar[e];
    oxi[base + e] = ai[e];
  }
}

// V^T from the identity, the logged rotations replayed on columns
// [blockIdx.x * V_COLS, +V_COLS) of V^T of matrix blockIdx.y
__global__ void __launch_bounds__(V_THREADS)
jacobi_v_kernel(const float* __restrict__ rlog, float* __restrict__ ovr,
                float* __restrict__ ovi, int n, int rounds) {
  extern __shared__ float smem[];
  float* vr = smem;  // (n, V_COLS)
  float* vi = smem + n * V_COLS;
  const int b = blockIdx.y;
  const int k0 = blockIdx.x * V_COLS;
  const int h = n / 2;
  for (int e = threadIdx.x; e < n * V_COLS; e += blockDim.x) {
    vr[e] = e / V_COLS == k0 + e % V_COLS ? 1.f : 0.f;
    vi[e] = 0.f;
  }
  __syncthreads();
  const float* lg = rlog + static_cast<size_t>(b) * rounds * 3 * h;
  const int items = h * V_COLS;
  int rr = 0;
  for (int r = 0; r < rounds; ++r) {
    const float* row = lg + static_cast<size_t>(r) * 3 * h;
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int p = it / V_COLS;
      const int k = it % V_COLS;
      const int2 col = pair_cols(rr, p, h, n);
      const float c = __ldg(row + p);
      const float scph = __ldg(row + h + p);
      const float ssph = __ldg(row + 2 * h + p);
      const int t = col.x * V_COLS + k;
      const int q = col.y * V_COLS + k;
      const float tr = vr[t], ti = vi[t], br = vr[q], bi = vi[q];
      vr[t] = c * tr - scph * br - ssph * bi;
      vi[t] = c * ti - scph * bi + ssph * br;
      vr[q] = c * br + scph * tr - ssph * ti;
      vi[q] = c * bi + scph * ti + ssph * tr;
    }
    __syncthreads();
    if (++rr == n - 1) rr = 0;
  }
  for (int e = threadIdx.x; e < n * V_COLS; e += blockDim.x) {
    const size_t off = (static_cast<size_t>(b) * n + e / V_COLS) * n + k0 + e % V_COLS;
    ovr[off] = vr[e];
    ovi[off] = vi[e];
  }
}

template <int EPL>
cudaError_t launch_a(const float* xr, const float* xi, float* oxr, float* oxi,
                     float* rlog, int batch, int n, int m, int rounds,
                     cudaStream_t stream) {
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(n) * m;
  cudaError_t err = cudaFuncSetAttribute(
      jacobi_a_kernel<EPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int h = n / 2;
  const int threads = 32 * (h < MAX_WARPS ? h : MAX_WARPS);
  jacobi_a_kernel<EPL><<<batch, threads, smem, stream>>>(xr, xi, oxr, oxi, rlog,
                                                          n, m, rounds);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tcng_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K5.  xr/xi (batch, n, m) transposed planes; oxr/oxi (batch, n, m) the
// rotated planes (row norms are the singular values); ovr/ovi (batch, n, n)
// V's transposed planes, or null for no V; rlog (batch, sweeps*(n-1), 3,
// n/2) scratch, needed with V.  n even, m <= 256, 8 n m bytes of shared
// memory at most, n a multiple of 16 with V.  Returns the first CUDA error,
// 0 on success.
int tcng_jacobi_svd(const float* xr, const float* xi, float* oxr, float* oxi,
                    float* ovr, float* ovi, float* rlog, int batch, int n,
                    int m, int sweeps, void* stream) {
  const bool with_v = ovr != nullptr;
  if (n < 2 || n % 2 || m < 1 || m > MAX_M || sweeps < 0 ||
      2 * sizeof(float) * static_cast<size_t>(n) * m > MAX_SMEM ||
      (with_v && (n % V_COLS || ovi == nullptr || rlog == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rounds = sweeps * (n - 1);
  float* lg = with_v ? rlog : nullptr;
  cudaError_t err;
  const int epl = (m + 31) / 32;
  if (epl <= 1)
    err = launch_a<1>(xr, xi, oxr, oxi, lg, batch, n, m, rounds, s);
  else if (epl <= 2)
    err = launch_a<2>(xr, xi, oxr, oxi, lg, batch, n, m, rounds, s);
  else if (epl <= 4)
    err = launch_a<4>(xr, xi, oxr, oxi, lg, batch, n, m, rounds, s);
  else
    err = launch_a<8>(xr, xi, oxr, oxi, lg, batch, n, m, rounds, s);
  if (err != cudaSuccess || !with_v) return static_cast<int>(err);
  const dim3 grid(n / V_COLS, batch);
  jacobi_v_kernel<<<grid, V_THREADS, 2 * sizeof(float) * n * V_COLS, s>>>(
      rlog, ovr, ovi, n, rounds);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
