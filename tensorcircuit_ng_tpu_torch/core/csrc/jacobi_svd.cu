// K5: one-sided (Hestenes) Jacobi SVD of a batch of complex matrices for
// Hopper (sm_90a), the whole sweep loop inside one kernel.
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
// 1/sqrt(mod2 + 1e-36), t = sign(tau) / (|tau| + sqrt(1 + tau^2)) with a
// three-way sign (sign(0) = 0: an exactly tied pair is not rotated that
// round), the relative skip guard mod2 <= 1e-24 app aqq, and the
// 12-multiply rotation.  A fixed sweep count, no convergence test.  Built
// without fast-math, so denormals are kept.
//
// What bounds it.  Per pair and round 36 m flops on A (16 for the four sums,
// 20 for the rotation) and 20 n on V: 17.5 GFLOP for the TEBD batch of
// B = 30 matrices of 128 x 128 at 10 sweeps, 0.26 ms at 67 TFLOP/s float32;
// bytes are negligible.  But the rounds are strictly sequential and each
// needs a sum over the whole column before its rotation, so the kernel is
// bound by the latency of a round, and by the shared-memory traffic of the
// SMs that hold one matrix.
//
// Design: one thread-block cluster of C CTAs a matrix (C in {1, 2, 4, 8},
// chosen by kernels_jacobi._cluster_size), launched with a cluster
// dimension.  Column rotations keep the elements of a column independent, so
// cluster rank r holds elements [r ms, (r+1) ms) of every column of A (ms =
// ceil(m / C)) and [r ns, (r+1) ns) of every column of V (ns = ceil(n / C))
// in its shared memory, and rotates them itself; only the four sums of a
// pair cross CTAs.  A round:
//   1. warp w takes pairs w, w + nwarps, ..., one a half-warp (and PPH at
//      once, their chains interleaved, where a half has more); a lane loads
//      its float2 elements of the pair's two columns of A and of V into
//      registers and sums its part of A's four column sums; a halving
//      exchange over the half (spread_sum) leaves each sum in a few lanes;
//   2. those lanes store it into slot [r] of every rank's partials buffer
//      (distributed shared memory, st.async), double-buffered by the
//      round's parity; each store counts its bytes on that rank's mbarrier
//      of the buffer;
//   3. the threads of step 4 wait on their own CTA's mbarrier, whose phase
//      completes when all C h partials of the round have landed;
//   4. one thread a pair adds the C partials from its own CTA's buffer in
//      rank order 0..C-1, so all CTAs of the cluster compute bit-identical
//      (c, s cos phi, s sin phi), and two runs agree bit for bit; it runs
//      the IEEE chain once a CTA and puts the rotation in shared memory;
//      __syncthreads;
//   5. every half-warp rotates the A and V elements it holds in registers
//      and stores them;
//   6. __syncthreads: the next round's columns are CTA-local.
// Steps 4 and 5 are apart, and a half-warp takes a pair: with every warp
// running the per-pair chain (about 150 instructions) for each of its own
// pairs, a round was bound by the issue slots of the SM, not by its shared
// memory, and more CTAs a matrix barely shortened it.
// No cluster barrier a round: barrier.cluster.arrive.release compiles to a
// GPU-wide memory fence (MEMBAR.ALL.GPU).  The parity buffer makes this
// safe: a CTA can store round r+2's partials into a buffer only after it
// has received every CTA's round r+1 partials, which each CTA sends after it
// has read round r's.  Columns stay in place: the tournament has period
// n-1, so the column in a slot at round r is a closed form of (r mod n-1,
// slot) (pair_cols), and after sweeps * (n-1) rounds every column is back
// in its own slot, the order the Pallas kernel writes.  A half-warp with more pairs than it holds in registers (PPH; only
// for n > 128 or slices wider than 32) loads a pair's elements again after
// the barrier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_WARPS = 32;
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
  // sqrt(x) = 2^-32 sqrt(2^64 x) exactly: below 2^-100 (a pair of nearly
  // zero columns) the scaled argument keeps sqrtf off its slow path
  const float x = mod2 + 1e-36f;
  const bool tiny = x < 0x1p-100f;
  const float inv_mod = 1.f / (sqrtf(x * (tiny ? 0x1p64f : 1.f)) * (tiny ? 0x1p-32f : 1.f));
  const float cph = pr * inv_mod;
  const float sph = pi * inv_mod;
  const float tau = (aqq - app) * 0.5f * inv_mod;
  // sign(tau) / y == sign(tau) * (1 / y) bit for bit (y >= 1): a reciprocal
  // has no slow path for a zero numerator, as the division has
  const float t = sign3(tau) * __frcp_rn(fabsf(tau) + sqrtf(1.f + tau * tau));
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

__device__ __forceinline__ void cluster_barrier() {
  __syncwarp();  // the .aligned barrier wants the warp converged
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// address a of this CTA's shared memory in cluster rank's
__device__ __forceinline__ unsigned cluster_addr(unsigned a, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// x to shared::cluster address a; its 4 bytes count on the mbarrier at bar
// (in a's CTA)
__device__ __forceinline__ void store_async(unsigned a, float x, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               :: "r"(a), "r"(__float_as_uint(x)), "r"(bar) : "memory");
}

__device__ __forceinline__ void bar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

// this CTA's one arrival at the mbarrier, expecting bytes more
__device__ __forceinline__ void bar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// wait for the phase of the mbarrier with this parity to complete; a
// watchdog traps after ~2^33 cycles (seconds), so that a lost partial ends
// the launch with an error instead of hanging the card
__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  const long long t0 = clock64();
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1ll << 33)) __trap();
  } while (!done);
}

// A warp works in half-warps: half g takes one pair, and its lane l the
// float2 elements e = 2 l + 32 k (k < E) of each of the pair's columns, so a
// load, a store and the address work serve two elements.

// a lane's E float2 of the pair's columns col.x (top) and col.y (bottom) in
// planes (pr, pi) of even row width w: x = (top re, top im, bottom re,
// bottom im)
template <int E>
__device__ __forceinline__ void load_pair(float2 (&x)[4][E], const float* pr,
                                          const float* pi, int2 col, int w,
                                          int l) {
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int e = 2 * l + 32 * k;
    const bool in = e < w;
    const float2 z = make_float2(0.f, 0.f);
    x[0][k] = in ? *reinterpret_cast<const float2*>(pr + col.x * w + e) : z;
    x[1][k] = in ? *reinterpret_cast<const float2*>(pi + col.x * w + e) : z;
    x[2][k] = in ? *reinterpret_cast<const float2*>(pr + col.y * w + e) : z;
    x[3][k] = in ? *reinterpret_cast<const float2*>(pi + col.y * w + e) : z;
  }
}

// p' = c p - s e^{-i phi} q ;  q' = s e^{i phi} p + c q
__device__ __forceinline__ void rotate4(float c, float scph, float ssph,
                                        float& tr, float& ti, float& br,
                                        float& bi) {
  const float ntr = c * tr - scph * br - ssph * bi;
  const float nti = c * ti - scph * bi + ssph * br;
  const float nbr = c * br + scph * tr - ssph * ti;
  const float nbi = c * bi + scph * ti + ssph * tr;
  tr = ntr;
  ti = nti;
  br = nbr;
  bi = nbi;
}

// the pair's columns rotated from the lane's elements x, stored
template <int E>
__device__ __forceinline__ void rotate_pair(float2 (&x)[4][E], float* pr,
                                            float* pi, int2 col, int w, int l,
                                            float c, float scph, float ssph) {
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int e = 2 * l + 32 * k;
    if (e < w) {
      rotate4(c, scph, ssph, x[0][k].x, x[1][k].x, x[2][k].x, x[3][k].x);
      rotate4(c, scph, ssph, x[0][k].y, x[1][k].y, x[2][k].y, x[3][k].y);
      *reinterpret_cast<float2*>(pr + col.x * w + e) = x[0][k];
      *reinterpret_cast<float2*>(pi + col.x * w + e) = x[1][k];
      *reinterpret_cast<float2*>(pr + col.y * w + e) = x[2][k];
      *reinterpret_cast<float2*>(pi + col.y * w + e) = x[3][k];
    }
  }
}

// the sums of NV values (4 or 8) over each half-warp, spread: each halving
// step sends half of a lane's values to the partner lane and keeps the other
// half, then a butterfly finishes the last one; value j ends in the 16 / NV
// lanes l of the half with (l >> SH) & (NV - 1) == j, SH = 4 - log2 NV, all
// with the same bits (every add pairs the same two terms)
template <int NV>
__device__ __forceinline__ float spread_sum(float (&x)[NV], int lane) {
  int o = 8;
#pragma unroll
  for (int half = NV / 2; half >= 1; half /= 2, o /= 2) {
    const bool up = lane & o;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const float send = up ? x[k] : x[k + half];
      const float keep = up ? x[k + half] : x[k];
      x[k] = keep + __shfl_xor_sync(FULL, send, o);
    }
  }
  for (; o > 0; o /= 2) x[0] += __shfl_xor_sync(FULL, x[0], o);
  return x[0];
}

// even row width of a slice in shared memory (float2 access)
__host__ __device__ __forceinline__ int even(int w) { return w + (w & 1); }

// dynamic shared memory of one CTA: the partials buffer [2][C][h], its two
// mbarriers (16 B) and the rotations [h], both of float4, and the A and V
// slices; mirrored by kernels_jacobi._smem_bytes
size_t smem_bytes(int n, int m, bool with_v, int c) {
  const size_t mw = even((m + c - 1) / c);
  const size_t nw = with_v ? even((n + c - 1) / c) : 0;
  return (2 * c + 1) * sizeof(float4) * (n / 2) + 16 +
         2 * sizeof(float) * n * (mw + nw);
}

// E: float2 steps of a column slice a lane holds (slice width <= 32 E);
// PPH: pairs a half-warp holds in registers at once
template <int E, int PPH, bool WITH_V>
__global__ void __launch_bounds__(32 * MAX_WARPS, 1)
jacobi_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
              float* __restrict__ oxr, float* __restrict__ oxi,
              float* __restrict__ ovr, float* __restrict__ ovi, int n, int m,
              int rounds) {
  constexpr int NV = 4 * PPH;
  constexpr int SH = NV == 4 ? 2 : 1;  // 4 - log2 NV
  constexpr int EV = WITH_V ? E : 1;
  cg::cluster_group cl = cg::this_cluster();
  const int nc = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const int mat = blockIdx.x / nc;
  const int h = n / 2;
  const int ms = (m + nc - 1) / nc;
  const int m0 = rank * ms;
  const int mlen = max(0, min(ms, m - m0));
  const int mw = even(ms);
  const int ns = WITH_V ? (n + nc - 1) / nc : 0;
  const int n0 = rank * ns;
  const int nlen = max(0, min(ns, n - n0));
  const int nw = WITH_V ? even(ns) : 0;
  extern __shared__ float4 smem[];
  float4* part = smem;  // [parity][rank][pair]: (app, aqq, Re a_pq, Im a_pq)
  // the partials buffers' mbarriers, by parity: a phase completes when
  // all C h partials of a round have landed
  const unsigned bars = static_cast<unsigned>(__cvta_generic_to_shared(part + 2 * nc * h));
  float4* rot = part + 2 * nc * h + 1;  // [pair]: (c, s cos phi, s sin phi, 0)
  float* ar = reinterpret_cast<float*>(rot + h);
  float* ai = ar + n * mw;
  float* vr = ai + n * mw;
  float* vi = vr + n * nw;
  const size_t base = static_cast<size_t>(mat) * n * m;
  for (int idx = threadIdx.x; idx < n * mw; idx += blockDim.x) {
    const int j = idx / mw;
    const int e = idx - j * mw;
    const bool in = e < mlen;
    ar[idx] = in ? xr[base + static_cast<size_t>(j) * m + m0 + e] : 0.f;
    ai[idx] = in ? xi[base + static_cast<size_t>(j) * m + m0 + e] : 0.f;
  }
  if constexpr (WITH_V) {
    // V^T from the identity; elements past the slice's end stay 0
    for (int idx = threadIdx.x; idx < n * nw; idx += blockDim.x) {
      const int j = idx / nw;
      const int e = idx - j * nw;
      vr[idx] = e < nlen && n0 + e == j ? 1.f : 0.f;
      vi[idx] = 0.f;
    }
  }
  if (threadIdx.x == 0) {
    bar_init(bars, 1);
    bar_init(bars + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every CTA of the cluster runs and holds its slices and mbarriers before
  // any remote store
  cluster_barrier();
  const int lane = threadIdx.x & 31;
  const int l = lane & 15;
  const int g = lane >> 4;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // warp w's pair slots k: p = w + nwarps k; half g takes k = g, g + 2, ...
  const int nhs = ((h + nwarps - 1) / nwarps + 1) / 2;  // slots of a half
  const bool reload = nhs > PPH;
  // the partial this lane stores: pair slot jq of a chunk, sum ji, to
  // ranks jk, jk + 2^SH, ...
  const int jv = (l >> SH) & (NV - 1);
  const int jq = jv >> 2;
  const int ji = jv & 3;
  const int jk = l & ((1 << SH) - 1);
  float2 a[PPH][4][E];
  float2 v[PPH][4][EV];
  int2 cols[PPH];
  int rr = 0;  // the round modulo n-1, the tournament's period
  for (int r = 0; r < rounds; ++r) {
    float4* pb = part + (r & 1) * nc * h;
    const unsigned bar = bars + 8 * (r & 1);
    if (threadIdx.x == 0) bar_expect(bar, 16 * nc * h);
    // 1-2. partial sums over this CTA's slice, stored to every rank
    for (int k0 = 0; k0 < nhs; k0 += PPH) {
      float sums[NV];
#pragma unroll
      for (int q = 0; q < PPH; ++q) {
        const int p = warp + nwarps * (2 * (k0 + q) + g);
        float app = 0.f, aqq = 0.f, pr = 0.f, pi = 0.f;
        if (p < h) {
          cols[q] = pair_cols(rr, p, h, n);
          load_pair<E>(a[q], ar, ai, cols[q], mw, l);
          if constexpr (WITH_V) load_pair<EV>(v[q], vr, vi, cols[q], nw, l);
#pragma unroll
          for (int k = 0; k < E; ++k) {
            const float2 tr = a[q][0][k], ti = a[q][1][k];
            const float2 br = a[q][2][k], bi = a[q][3][k];
            app += tr.x * tr.x + ti.x * ti.x;
            app += tr.y * tr.y + ti.y * ti.y;
            aqq += br.x * br.x + bi.x * bi.x;
            aqq += br.y * br.y + bi.y * bi.y;
            // a_pq = <p, q> (conjugate on p)
            pr += tr.x * br.x + ti.x * bi.x;
            pr += tr.y * br.y + ti.y * bi.y;
            pi += tr.x * bi.x - ti.x * br.x;
            pi += tr.y * bi.y - ti.y * br.y;
          }
        }
        sums[4 * q] = app;
        sums[4 * q + 1] = aqq;
        sums[4 * q + 2] = pr;
        sums[4 * q + 3] = pi;
      }
      const float x = spread_sum<NV>(sums, lane);
      const int p = warp + nwarps * (2 * (k0 + jq) + g);
      if (p < h) {
        const unsigned dst = static_cast<unsigned>(
            __cvta_generic_to_shared(reinterpret_cast<float*>(pb + rank * h + p) + ji));
        for (int k = jk; k < nc; k += 1 << SH)
          store_async(cluster_addr(dst, k), x, cluster_addr(bar, k));
      }
    }
    // 3. the threads that take a pair in step 4 wait until the cluster's
    // partials of this round have landed
    if (threadIdx.x < h) bar_wait(bar, (r >> 1) & 1);
    // 4. each pair's rotation once a CTA, one pair a thread: the sums in
    // rank order, the same bits in every CTA of the cluster
    for (int p = threadIdx.x; p < h; p += blockDim.x) {
      float4 t = pb[p];
      for (int k = 1; k < nc; ++k) {
        const float4 u = pb[k * h + p];
        t.x += u.x;
        t.y += u.y;
        t.z += u.z;
        t.w += u.w;
      }
      float c, scph, ssph;
      rotation(t.x, t.y, t.z, t.w, &c, &scph, &ssph);
      rot[p] = make_float4(c, scph, ssph, 0.f);
    }
    __syncthreads();
    // 5. rotate the elements held in registers
    for (int k0 = 0; k0 < nhs; k0 += PPH) {
#pragma unroll
      for (int q = 0; q < PPH; ++q) {
        const int p = warp + nwarps * (2 * (k0 + q) + g);
        if (p < h) {
          if (reload) {
            cols[q] = pair_cols(rr, p, h, n);
            load_pair<E>(a[q], ar, ai, cols[q], mw, l);
            if constexpr (WITH_V) load_pair<EV>(v[q], vr, vi, cols[q], nw, l);
          }
          const float4 t = rot[p];
          rotate_pair<E>(a[q], ar, ai, cols[q], mw, l, t.x, t.y, t.z);
          if constexpr (WITH_V)
            rotate_pair<EV>(v[q], vr, vi, cols[q], nw, l, t.x, t.y, t.z);
        }
      }
    }
    // 6. the next round's columns are CTA-local
    __syncthreads();
    if (++rr == n - 1) rr = 0;
  }
  for (int idx = threadIdx.x; idx < n * mw; idx += blockDim.x) {
    const int j = idx / mw;
    const int e = idx - j * mw;
    if (e < mlen) {
      oxr[base + static_cast<size_t>(j) * m + m0 + e] = ar[idx];
      oxi[base + static_cast<size_t>(j) * m + m0 + e] = ai[idx];
    }
  }
  if constexpr (WITH_V) {
    const size_t vbase = static_cast<size_t>(mat) * n * n;
    for (int idx = threadIdx.x; idx < n * nw; idx += blockDim.x) {
      const int j = idx / nw;
      const int e = idx - j * nw;
      if (e < nlen) {
        ovr[vbase + static_cast<size_t>(j) * n + n0 + e] = vr[idx];
        ovi[vbase + static_cast<size_t>(j) * n + n0 + e] = vi[idx];
      }
    }
  }
  // no CTA leaves while another may still address its shared memory
  cluster_barrier();
}

using KernelFn = void (*)(const float*, const float*, float*, float*, float*,
                          float*, int, int, int);

template <bool V>
KernelFn pick(int e, int pph) {
  if (e == 1) return pph == 1 ? jacobi_kernel<1, 1, V> : jacobi_kernel<1, 2, V>;
  if (e == 2) return jacobi_kernel<2, 1, V>;
  if (e == 4) return jacobi_kernel<4, 1, V>;
  return jacobi_kernel<8, 1, V>;
}

struct Plan {
  KernelFn fn;
  int threads;
  size_t smem;
};

// the kernel, its block size and shared memory for a shape and cluster
// size c; false if the shape or c is not supported
bool plan(int n, int m, bool with_v, int c, Plan* out) {
  if (n < 2 || n % 2 || m < 1 || m > MAX_M ||
      2 * sizeof(float) * static_cast<size_t>(n) * m > MAX_SMEM)
    return false;
  if (c != 1 && c != 2 && c != 4 && c != 8) return false;
  const size_t smem = smem_bytes(n, m, with_v, c);
  if (smem > MAX_SMEM) return false;
  const int h = n / 2;
  const int nwarps = (h + 1) / 2 < MAX_WARPS ? (h + 1) / 2 : MAX_WARPS;
  const int nhs = ((h + nwarps - 1) / nwarps + 1) / 2;
  const int mw = even((m + c - 1) / c);
  const int nw = with_v ? even((n + c - 1) / c) : 0;
  const int width = mw > nw ? mw : nw;
  int e = 1;
  while (32 * e < width) e *= 2;
  if (e > 8) return false;
  out->fn = with_v ? pick<true>(e, e == 1 && nhs > 1 ? 2 : 1)
                   : pick<false>(e, e == 1 && nhs > 1 ? 2 : 1);
  out->threads = 32 * nwarps;
  out->smem = smem;
  return true;
}

cudaLaunchConfig_t config(const Plan& p, int clusters, int c, cudaStream_t s,
                          cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * c);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

const char* tcng_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// cudaOccupancyMaxActiveClusters of K5 at a shape (with_v 0/1) and cluster
// size c: the clusters of c CTAs the current device runs at once; minus a
// cudaError_t on failure
int tcng_jacobi_max_clusters(int n, int m, int with_v, int c) {
  Plan p;
  if (!plan(n, m, with_v != 0, c, &p)) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(p.fn),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p.smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(p, 1, c, nullptr, &attr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, reinterpret_cast<const void*>(p.fn), &cfg);
  return err != cudaSuccess ? -static_cast<int>(err) : count;
}

// K5.  xr/xi (batch, n, m) transposed planes; oxr/oxi (batch, n, m) the
// rotated planes (row norms are the singular values); ovr/ovi (batch, n, n)
// V's transposed planes, or null for no V; cluster: CTAs a matrix (1, 2, 4
// or 8).  n even, m <= 256, 8 n m bytes at most, and the slices of one CTA
// within its shared memory.  Returns the first CUDA error, 0 on success.
int tcng_jacobi_svd(const float* xr, const float* xi, float* oxr, float* oxi,
                    float* ovr, float* ovi, int batch, int n, int m,
                    int sweeps, int cluster, void* stream) {
  const bool with_v = ovr != nullptr;
  Plan p;
  if (sweeps < 0 || (with_v && ovi == nullptr) || !plan(n, m, with_v, cluster, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(p.fn),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(p, batch, cluster, static_cast<cudaStream_t>(stream), &attr);
  const int rounds = sweeps * (n - 1);
  err = cudaLaunchKernelEx(&cfg, p.fn, xr, xi, oxr, oxi, ovr, ovi, n, m, rounds);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
