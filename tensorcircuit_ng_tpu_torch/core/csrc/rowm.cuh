// Row-kron stages of the FUSE_ROWM branch (K13 inside tcng_zzrx_fwd, K14
// inside tcng_zzrx_bwd) on the (r, 128) float32 plane pair of a complex64
// statevector.  Layout index = row * 128 + lane.
//
// They replace kernels_rowlayer._rowm_fwd_stage and _rowm_bwd_stage, the
// rmx > 0 branch of the Pallas zzrx kernels: the top rmx row bits of each
// block of rb = 2^nkernel rows ride as ONE (R, R) left-matmul, R = 2^rmx
// (1..7), by M7 = kron(rx(th_0), ..., rx(th_{rmx-1})), instead of rmx
// butterflies.  Each block is seen as an R x C row-major matrix, C = rb /
// R * 128, and the blocks side by side as one R x K matrix, K = r * 128 / R
// columns (at n = 20: 8 blocks of 128 x 1024 complex, K = 8192).  Nothing
// here uses the kron's structure: M7 is any complex matrix.
//
//   rowm_apply_kernel<R, false> (K13): y = M7 x;
//   rowm_apply_kernel<R, true> (K14a): x = M7^dagger y (the un-apply) and
//     c' = M7^T c (the cotangent walk), sharing each M7 load;
//   rowm_dm_kernel<R> + colsum_kernel (K14b): dM7 = sum_g c x^T, the
//     non-conjugating product, split over K: one partial a chunk of
//     columns, added in a fixed order (no float atomics: bit for bit over
//     two runs).
//
// Bound: operations, 8 R flops an amplitude a product (at n = 20, R = 128:
// 1.07 GFLOP, 16.0 us at 67 TFLOP/s float32 outside the tensor cores),
// while the state moves 16.8 MB (K13) or 33.6 MB (K14a) through the L2.
// So each stage is a register-blocked float32 GEMM: every thread owns a
// micro-tile of outputs, reads its operands from shared memory as float4
// (or float2) vectors, and writes each complex multiply-add as two fmaf a
// plane (as a += b*c - d*e nvcc emits FMUL, FFMA and FADD: half again the
// issue slots).  Plain FMAs, no TF32, no fast-math.
//
// Apply (K13, K14a).  A CTA owns column tiles of CW columns x all R rows:
// it reads all R rows of a tile before it writes any, and tiles are
// disjoint, so the stage runs in place (K13 on K1's row-stage output,
// K14a on the lane stage's psi).  The grid is persistent, min(tiles, SMs x CTAs an SM);
// M7's planes are copied once a CTA into shared memory (row stride R + 4:
// rows four apart fall in different banks).  The copies are cp.async of
// 16 B (a tile row is a strided run of CW floats of a block row), and the
// first tile arrives in chunks of 32 k rows, each with the same chunk of
// M7 (K13's columns k, K14a's rows k), so its FFMAs start on chunk 0 while
// the rest of M7 is in flight.  Then one tile buffer: the next tile is
// copied after the current one is written (two buffers beside M7 do not
// fit at these tile widths, and at n = 20 K13 has one tile a CTA and
// K14a about two).  R is a template parameter, and the operands of step
// k + KS are loaded into registers before step k's FFMAs (8 warps an SM).
//   K13: 8 x 4 outputs a thread, CW = 64 at R = 128 (128 tiles at n = 20);
//     a step of KS = 4 k reads 8 rows of M7 along k (one float4 a plane,
//     a quarter warp on one address) and 4 tile rows (float4, 8
//     neighbouring vectors a quarter warp): 24 loads for 512 FFMAs.
//   K14a: 4 x 4 outputs a thread in each of its two products, CW = 32 (256
//     tiles); a step reads M7's row k at the thread's 4 columns (float4)
//     and row k of y and c: 6 loads for 128 FFMAs.
//   Budget at R = 128: M7 2 x 128 x 132 x 4 B = 135,168 B, the tile
//   65,536 B (K13: 2 planes x 128 x 64; K14a: 4 planes x 128 x 32): 200,704
//   B of the 232,448 a CTA may take, so one CTA (8 warps) an SM.
//
// dM7 (K14b).  Split-K: the R x R output in tiles of T = min(R, 64), the K
// columns in chunks (rowm_dm_chunk: about 256 CTAs, two an SM, 16 warps),
// each CTA streaming its chunk through two cp.async stages of KS = 32
// columns of the c and x rows it needs (row stride 36), a thread owning a
// 4 x 4 micro-tile with rows and columns strided by T/4 (a quarter warp
// then reads 8 consecutive x rows: conflict-free; one c row: broadcast):
// 16 float4 loads for 256 FFMAs.  Budget: 2 stages x 4 planes x 64 x 36 x
// 4 B = 73,728 B and 128 registers a thread, for two CTAs an SM.  Folding
// dM7 into K14a's pass, as the TPU does, would need each CTA to carry a
// 128 x 128 complex partial (128 KB) beside M7 and its tile: it does not
// fit, so dM7 stays a pass of its own over c and x (both in the L2).

#pragma once

#include <type_traits>

#include "lane.cuh"

namespace {

__host__ __device__ constexpr int ilog2c(int v) { return v <= 1 ? 0 : 1 + ilog2c(v >> 1); }

// Offset of element (row k, column g) of the R x K view: column g is
// column g % C of block g / C, whose row k is state row (g / C) * R + k.
template <int R>
__device__ __forceinline__ long rowm_off(long g, int k, int lc) {
  constexpr int LR = ilog2c(R);
  return ((((g >> lc) << LR) + k) << lc) + (g & ((1L << lc) - 1));
}

// Tile geometry of the apply stages (all compile-time).
template <int R, bool BWD>
struct ApplyGeom {
  static constexpr int RTM = BWD ? 4 : 8;      // K13 8 x 4 outputs a thread, K14a 4 x 4 (twice)
  static constexpr int RT = R < RTM ? R : RTM; // output rows a thread
  static constexpr int NQ = 4;                 // output columns a thread
  static constexpr int RG = R / RT;            // row groups
  static constexpr int CG = THREADS / RG;      // column groups (>= 8)
  static constexpr int CW = NQ * CG;           // columns a tile
  static constexpr int NP = BWD ? 4 : 2;       // planes of a tile
  static constexpr int RS = R + 4;             // row stride of M7 in smem
  static constexpr int KS = BWD ? 1 : (R < 4 ? R : 4);  // k a step
  static constexpr int KC = R < 32 ? R : 32;   // k rows a chunk of the first tile
  static constexpr int NCH = R / KC;           // chunks a tile
  static constexpr int TILE = R * CW;          // floats of a tile plane
  static constexpr size_t SMEM = sizeof(float) * (2 * R * RS + NP * TILE);
};

// cp_async_wait<n> for a count n known only after unrolling
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    default: cp_async_wait<4>(); break;
  }
}

// BWD false: (o1) <- M (i1).  BWD true: (o1) <- M^dagger (i1) and
// (o2) <- M^T (i2).  ncols = K, the columns of the R x K view; o1 may alias
// i1 and o2 may alias i2.  Every pointer is 16-byte aligned.
template <int R, bool BWD>
__global__ void __launch_bounds__(THREADS, 1)
rowm_apply_kernel(const float* i1r, const float* i1i, const float* i2r,
                  const float* i2i, float* o1r, float* o1i, float* o2r,
                  float* o2i, const float* __restrict__ mr,
                  const float* __restrict__ mi, int lc, long ncols) {
  using G = ApplyGeom<R, BWD>;
  constexpr int RT = G::RT, NQ = G::NQ, CW = G::CW, RS = G::RS, KS = G::KS, KC = G::KC;
  constexpr int NCH = G::NCH;
  extern __shared__ __align__(16) float smem[];
  float* ms_r = smem;
  float* ms_i = smem + R * RS;
  float* x = smem + 2 * R * RS;  // the tile's NP planes, row k at x + k * CW
  const long ntiles = (ncols + CW - 1) / CW;

  // rows [k0, k0 + nk) of the NP planes of tile t into the tile buffer
  auto load_rows = [&](long t, int k0, int nk) {
    constexpr int CH = CW / 4;
    for (int e = threadIdx.x; e < G::NP * nk * CH; e += THREADS) {
      const int p = e / (nk * CH), k = k0 + (e / CH) % nk, q = e % CH;
      const float* src = p == 0 ? i1r : p == 1 ? i1i : p == 2 ? i2r : i2i;
      const long g = t * CW + 4 * q;
      if (g < ncols) cp_async16(x + p * G::TILE + k * CW + 4 * q, src + rowm_off<R>(g, k, lc));
    }
  };
  // M7 once a CTA (ms[row * RS + col] = M[row][col]), in NCH k chunks that
  // arrive with the first tile's rows of the same chunk (K13 reads M's
  // columns k, K14a its rows k), so the first tile starts on chunk 0
  if constexpr (R < 4) {
    if (threadIdx.x < R * R) {
      ms_r[(threadIdx.x / R) * RS + threadIdx.x % R] = mr[threadIdx.x];
      ms_i[(threadIdx.x / R) * RS + threadIdx.x % R] = mi[threadIdx.x];
    }
  }
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    if constexpr (R >= 4) {
      for (int e = threadIdx.x; e < R * KC / 4; e += THREADS) {
        const int row = BWD ? c * KC + e / (R / 4) : e / (KC / 4);
        const int col = BWD ? 4 * (e % (R / 4)) : c * KC + 4 * (e % (KC / 4));
        cp_async16(ms_r + row * RS + col, mr + row * R + col);
        cp_async16(ms_i + row * RS + col, mi + row * R + col);
      }
    }
    load_rows(blockIdx.x, c * KC, KC);
    cp_async_commit();
  }

  const int rg = threadIdx.x / G::CG, cg = threadIdx.x % G::CG;
  const int i0 = rg * RT, j0 = cg * NQ;
  for (long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const bool first = t == blockIdx.x;
    if (!first) {
      cp_async_wait<0>();  // tile t has landed (this thread's copies)
      __syncthreads();     // ... and every thread's
    }
    float ar[RT][NQ], ai[RT][NQ], br[RT][NQ], bi[RT][NQ];
#pragma unroll
    for (int a = 0; a < RT; ++a)
#pragma unroll
      for (int q = 0; q < NQ; ++q) ar[a][q] = ai[a][q] = br[a][q] = bi[a][q] = 0.f;
#pragma unroll 1
    for (int c = 0; c < NCH; ++c) {
      const int k0 = c * KC;
      if (first) {
        cp_async_wait_n(NCH - 1 - c);  // chunk c of M7 and of tile t
        __syncthreads();
      }
      if constexpr (!BWD) {
        // y[i][j] = sum_k M[i][k] x[k][j]: M rows i0.. along k (KS floats),
        // tile rows k.. (NQ floats)
        float m_r[2][RT][KS], m_i[2][RT][KS], u_r[2][KS][NQ], u_i[2][KS][NQ];
        auto fetch = [&](int s, int k) {
#pragma unroll
          for (int a = 0; a < RT; ++a) {
            vload<KS>(ms_r + (i0 + a) * RS + k, m_r[s][a]);
            vload<KS>(ms_i + (i0 + a) * RS + k, m_i[s][a]);
          }
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            vload<NQ>(x + (k + kk) * CW + j0, u_r[s][kk]);
            vload<NQ>(x + G::TILE + (k + kk) * CW + j0, u_i[s][kk]);
          }
        };
        auto fma = [&](int s) {
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
#pragma unroll
            for (int a = 0; a < RT; ++a)
#pragma unroll
              for (int q = 0; q < NQ; ++q) {
                const float mr_ = m_r[s][a][kk], mi_ = m_i[s][a][kk];
                const float ur_ = u_r[s][kk][q], ui_ = u_i[s][kk][q];
                ar[a][q] = fmaf(-mi_, ui_, fmaf(mr_, ur_, ar[a][q]));
                ai[a][q] = fmaf(mi_, ur_, fmaf(mr_, ui_, ai[a][q]));
              }
        };
        fetch(0, k0);
        if constexpr (KC >= 2 * KS) {
          // step k + KS is in registers before step k's FFMAs, and so on
          for (int k = k0; k < k0 + KC; k += 2 * KS) {
            fetch(1, k + KS);
            fma(0);
            fetch(0, k0 + ((k + 2 * KS - k0) & (KC - 1)));  // wraps in the chunk (unused)
            fma(1);
          }
        } else {
          fma(0);
        }
      } else {
        // x[i][j] = sum_k conj(M[k][i]) y[k][j], c'[i][j] = sum_k M[k][i]
        // c[k][j]: M row k at columns i0.. (RT floats), tile rows k (NQ)
        float m_r[2][RT], m_i[2][RT], y_r[2][NQ], y_i[2][NQ], c_r[2][NQ], c_i[2][NQ];
        auto fetch = [&](int s, int k) {
          vload<RT>(ms_r + k * RS + i0, m_r[s]);
          vload<RT>(ms_i + k * RS + i0, m_i[s]);
          vload<NQ>(x + k * CW + j0, y_r[s]);
          vload<NQ>(x + G::TILE + k * CW + j0, y_i[s]);
          vload<NQ>(x + 2 * G::TILE + k * CW + j0, c_r[s]);
          vload<NQ>(x + 3 * G::TILE + k * CW + j0, c_i[s]);
        };
        auto fma = [&](int s) {
#pragma unroll
          for (int a = 0; a < RT; ++a)
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
              const float mr_ = m_r[s][a], mi_ = m_i[s][a];
              ar[a][q] = fmaf(mi_, y_i[s][q], fmaf(mr_, y_r[s][q], ar[a][q]));
              ai[a][q] = fmaf(-mi_, y_r[s][q], fmaf(mr_, y_i[s][q], ai[a][q]));
              br[a][q] = fmaf(-mi_, c_i[s][q], fmaf(mr_, c_r[s][q], br[a][q]));
              bi[a][q] = fmaf(mi_, c_r[s][q], fmaf(mr_, c_i[s][q], bi[a][q]));
            }
        };
        fetch(0, k0);
        for (int k = k0; k < k0 + KC; k += 2) {  // KC >= 2
          fetch(1, k + 1);
          fma(0);
          fetch(0, k0 + ((k + 2 - k0) & (KC - 1)));
          fma(1);
        }
      }
    }
    const long g = t * CW + j0;
    if (g < ncols) {
#pragma unroll
      for (int a = 0; a < RT; ++a) {
        const long off = rowm_off<R>(g, i0 + a, lc);
        vstore<NQ>(o1r + off, ar[a]);
        vstore<NQ>(o1i + off, ai[a]);
        if constexpr (BWD) {
          vstore<NQ>(o2r + off, br[a]);
          vstore<NQ>(o2i + off, bi[a]);
        }
      }
    }
    __syncthreads();  // the tile is consumed before the next one is copied over it
    if (t + gridDim.x < ntiles) load_rows(t + gridDim.x, 0, R);
    cp_async_commit();
  }
}

// f(std::integral_constant<int, R>) for R = 2^rmx, rmx = 1..7.
template <typename F>
cudaError_t with_rowm_r(int rmx, F&& f) {
  switch (rmx) {
    case 1: return f(std::integral_constant<int, 2>{});
    case 2: return f(std::integral_constant<int, 4>{});
    case 3: return f(std::integral_constant<int, 8>{});
    case 4: return f(std::integral_constant<int, 16>{});
    case 5: return f(std::integral_constant<int, 32>{});
    case 6: return f(std::integral_constant<int, 64>{});
    case 7: return f(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

// CTAs a kernel keeps on each SM, and the SMs of the current device.
cudaError_t sm_slots(const void* kern, size_t smem, int* nsm, int* occ) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kern, THREADS, smem);
  return err;
}

// out: [0] CW, [1] tiles, [2] grid, [3] shared bytes, [4] CTAs an SM,
// [5] registers a thread, [6] local bytes a thread.  Sets the kernel's
// shared-memory limit.
template <bool BWD>
cudaError_t rowm_apply_plan(int rmx, int r, long* out) {
  return with_rowm_r(rmx, [&](auto rc) {
    constexpr int R = decltype(rc)::value;
    using G = ApplyGeom<R, BWD>;
    const void* kern = reinterpret_cast<const void*>(rowm_apply_kernel<R, BWD>);
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(G::SMEM));
    int nsm = 0, occ = 0;
    if (err == cudaSuccess) err = sm_slots(kern, G::SMEM, &nsm, &occ);
    cudaFuncAttributes fa;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kern);
    if (err != cudaSuccess) return err;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    const long ncols = (static_cast<long>(r) * LANES) >> rmx;
    const long tiles = (ncols + G::CW - 1) / G::CW;
    const long slots = static_cast<long>(nsm) * occ;
    const long vals[7] = {G::CW, tiles, tiles < slots ? tiles : slots,
                          static_cast<long>(G::SMEM), occ, fa.numRegs,
                          static_cast<long>(fa.localSizeBytes)};
    for (int i = 0; i < 7; ++i) out[i] = vals[i];
    return cudaSuccess;
  });
}

template <bool BWD>
cudaError_t rowm_apply(const float* i1r, const float* i1i, const float* i2r,
                       const float* i2i, float* o1r, float* o1i, float* o2r,
                       float* o2i, const float* mr, const float* mi, int r,
                       int nkernel, int rmx, cudaStream_t st) {
  const void* ptrs[10] = {i1r, i1i, i2r, i2i, o1r, o1i, o2r, o2i, mr, mi};
  for (const void* p : ptrs)
    if (!aligned16(p)) return cudaErrorMisalignedAddress;
  const int lc = nkernel - rmx + 7;  // log2 of a block matrix's columns
  const long ncols = (static_cast<long>(r) * LANES) >> rmx;
  return with_rowm_r(rmx, [&](auto rc) {
    constexpr int R = decltype(rc)::value;
    using G = ApplyGeom<R, BWD>;
    const void* kern = reinterpret_cast<const void*>(rowm_apply_kernel<R, BWD>);
    static long slots = 0;  // SMs x CTAs an SM, found at the first launch
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(G::SMEM));
    if (err == cudaSuccess && slots == 0) {
      int nsm = 0, occ = 0;
      err = sm_slots(kern, G::SMEM, &nsm, &occ);
      slots = static_cast<long>(nsm) * occ;
    }
    if (err != cudaSuccess) return err;
    if (slots < 1) return cudaErrorInvalidConfiguration;
    const long tiles = (ncols + G::CW - 1) / G::CW;
    rowm_apply_kernel<R, BWD><<<static_cast<unsigned>(tiles < slots ? tiles : slots), THREADS, G::SMEM,
                                st>>>(i1r, i1i, i2r, i2i, o1r, o1i, o2r, o2i, mr, mi, lc, ncols);
    return cudaGetLastError();
  });
}

// Geometry of the dM7 stage (all compile-time).
template <int R>
struct DmGeom {
  static constexpr int T = R < 64 ? R : 64;    // output tile edge
  static constexpr int RT = T < 4 ? T : 4;     // micro-tile edge
  static constexpr int TG = T / RT;            // thread groups an edge
  static constexpr int KS = 32;                // columns a stage
  static constexpr int KP = KS + 4;            // row stride of a stage
  static constexpr int TILES = (R / T) * (R / T);
  static constexpr int STAGE = 4 * T * KP;     // floats: c r/i, x r/i
  static constexpr size_t SMEM = sizeof(float) * 2 * STAGE;  // two stages
};

// Columns of one dM7 partial: about 256 CTAs (two on each SM), at least
// one stage of 32 columns each.
long rowm_dm_chunk(int r, int rmx) {
  const long k = (static_cast<long>(r) * LANES) >> rmx;
  const int R = 1 << rmx;
  const int t = R < 64 ? R : 64;
  const long tiles = static_cast<long>(R / t) * (R / t);
  long kc = k / (256 / tiles);
  if (kc < 32) kc = 32;
  return kc < k ? kc : k;
}

// Floats of the dM7 partials.
size_t rowm_dm_floats(int r, int rmx) {
  const long k = (static_cast<long>(r) * LANES) >> rmx;
  return static_cast<size_t>(k / rowm_dm_chunk(r, rmx)) * 2 << (2 * rmx);
}

// part[blockIdx.y] (2, R, R) planes, tile blockIdx.x: the sum over the
// chunk's kc columns g of c[i][g] * x[j][g], the non-conjugating product.
template <int R>
__global__ void __launch_bounds__(THREADS, 2)
rowm_dm_kernel(const float* cr, const float* ci, const float* xr,
               const float* xi, float* part, int lc, long kc) {
  using G = DmGeom<R>;
  constexpr int T = G::T, RT = G::RT, TG = G::TG, KS = G::KS, KP = G::KP;
  extern __shared__ __align__(16) float smem[];
  const int i0 = (blockIdx.x / (R / T)) * T;
  const int j0 = (blockIdx.x % (R / T)) * T;
  const long g0 = blockIdx.y * kc;
  const int nst = static_cast<int>(kc / KS);
  // stage s into buffer s % 2: planes c r/i (rows i0..), x r/i (rows j0..)
  auto load = [&](int s) {
    constexpr int CH = KS / 4;
    float* buf = smem + (s & 1) * G::STAGE;
    for (int e = threadIdx.x; e < 4 * T * CH; e += THREADS) {
      const int p = e / (T * CH), row = (e / CH) % T, q = e % CH;
      const float* src = p == 0 ? cr : p == 1 ? ci : p == 2 ? xr : xi;
      const long g = g0 + s * KS + 4 * q;
      cp_async16(buf + (p * T + row) * KP + 4 * q, src + rowm_off<R>(g, (p < 2 ? i0 : j0) + row, lc));
    }
  };
  const int rg = threadIdx.x / TG, cg = threadIdx.x % TG;
  const bool active = threadIdx.x < TG * TG;
  float acc_r[RT][RT], acc_i[RT][RT];
#pragma unroll
  for (int a = 0; a < RT; ++a)
#pragma unroll
    for (int b = 0; b < RT; ++b) acc_r[a][b] = acc_i[a][b] = 0.f;
  load(0);
  cp_async_commit();
  for (int s = 0; s < nst; ++s) {
    if (s + 1 < nst) load(s + 1);
    cp_async_commit();
    cp_async_wait<1>();  // stage s has landed
    __syncthreads();
    const float* buf = smem + (s & 1) * G::STAGE;
    if (active) {
#pragma unroll 1
      for (int k = 0; k < KS; k += 4) {
        float c_r[RT][4], c_i[RT][4], x_r[RT][4], x_i[RT][4];
#pragma unroll
        for (int a = 0; a < RT; ++a) {
          vload<4>(buf + (rg + TG * a) * KP + k, c_r[a]);
          vload<4>(buf + (T + rg + TG * a) * KP + k, c_i[a]);
          vload<4>(buf + (2 * T + cg + TG * a) * KP + k, x_r[a]);
          vload<4>(buf + (3 * T + cg + TG * a) * KP + k, x_i[a]);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int a = 0; a < RT; ++a)
#pragma unroll
            for (int b = 0; b < RT; ++b) {
              acc_r[a][b] = fmaf(-c_i[a][kk], x_i[b][kk], fmaf(c_r[a][kk], x_r[b][kk], acc_r[a][b]));
              acc_i[a][b] = fmaf(c_i[a][kk], x_r[b][kk], fmaf(c_r[a][kk], x_i[b][kk], acc_i[a][b]));
            }
      }
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }
  if (!active) return;
  constexpr long RR = static_cast<long>(R) * R;
  float* out = part + blockIdx.y * 2 * RR;
#pragma unroll
  for (int a = 0; a < RT; ++a)
#pragma unroll
    for (int b = 0; b < RT; ++b) {
      const long o = static_cast<long>(i0 + rg + TG * a) * R + j0 + cg + TG * b;
      out[o] = acc_r[a][b];
      out[RR + o] = acc_i[a][b];
    }
}

// out: [0] tile edge, [1] tiles, [2] chunks, [3] columns a chunk, [4]
// shared bytes, [5] CTAs an SM, [6] registers a thread, [7] local bytes.
cudaError_t rowm_dm_plan(int rmx, int r, long* out) {
  return with_rowm_r(rmx, [&](auto rc) {
    constexpr int R = decltype(rc)::value;
    using G = DmGeom<R>;
    const void* kern = reinterpret_cast<const void*>(rowm_dm_kernel<R>);
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(G::SMEM));
    int nsm = 0, occ = 0;
    if (err == cudaSuccess) err = sm_slots(kern, G::SMEM, &nsm, &occ);
    cudaFuncAttributes fa;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kern);
    if (err != cudaSuccess) return err;
    const long kc = rowm_dm_chunk(r, rmx);
    const long vals[8] = {G::T, G::TILES, ((static_cast<long>(r) * LANES) >> rmx) / kc, kc,
                          static_cast<long>(G::SMEM), occ, fa.numRegs,
                          static_cast<long>(fa.localSizeBytes)};
    for (int i = 0; i < 8; ++i) out[i] = vals[i];
    return cudaSuccess;
  });
}

// dm7 (2, R, R) <- sum over all blocks of c x^T; part holds rowm_dm_floats.
cudaError_t rowm_dm(const float* cr, const float* ci, const float* xr,
                    const float* xi, float* part, float* dm7, int r,
                    int nkernel, int rmx, cudaStream_t st) {
  const void* ptrs[4] = {cr, ci, xr, xi};
  for (const void* p : ptrs)
    if (!aligned16(p)) return cudaErrorMisalignedAddress;
  long plan[8];
  cudaError_t err = rowm_dm_plan(rmx, r, plan);
  if (err != cudaSuccess) return err;
  const int lc = nkernel - rmx + 7;
  err = with_rowm_r(rmx, [&](auto rc) {
    constexpr int R = decltype(rc)::value;
    rowm_dm_kernel<R><<<dim3(static_cast<unsigned>(plan[1]), static_cast<unsigned>(plan[2])), THREADS,
                        plan[4], st>>>(cr, ci, xr, xi, part, lc, plan[3]);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  const int w = 2 << (2 * rmx);
  return colsum(part, static_cast<int>(plan[2]), w, dm7, w, 0, st);
}

}  // namespace
