// Forward zzrx kernels for Hopper (sm_90a): one TFIM layer (K1) and the
// whole L-layer stack (K2) on the (r, 128) float32 plane pair of a
// complex64 statevector.  Layout index = row * 128 + lane; qubit q is bit
// n-1-q of the flat index.
//
// K1 tcng_zzrx_fwd replaces kernels_rowlayer._pallas_zzrx_fwd
//    (_zzrx_fwd_kernel, _butterfly_rx, _lane_fwd_epilogue): zz phase
//    exp(-i/2 sum_k th_k Z_a Z_b) over all n qubits, rx on the nkernel
//    in-block row bits, then optionally y = x @ M with the 128x128 lane
//    matrix M.  With the (R, R) row-kron planes M7 (the FUSE_ROWM branch,
//    kernels_rowlayer._rowm_fwd_stage) pass A runs only the low
//    nkernel - rmx butterflies and stage K13 (rowm.cuh) applies M7 to the
//    top rmx row bits of each block before the lane stage.
// K2 tcng_grand_zzrx_fwd replaces kernels_grand.grand_zzrx_fwd
//    (_grand_fwd_kernel): L layers of K1-with-lane, each followed by the
//    outer (D, D) left-matmul across the G = D row blocks, streaming out
//    the post-lane, pre-outer residual ks[l].
//
// Design.  A Pallas block holds RB = 2^nkernel rows x 128 lanes (1 MB at
// RB = 1024), far above a CTA's 227 KB of shared memory, and the row
// butterflies need every row of a lane while the lane matmul needs every
// lane of a row.  So a layer runs as two passes over the state, which at
// n = 20 (8.4 MB) stays in the 50 MB L2:
//   pass A (zz_rowrx_kernel): a CTA holds an RB x TL tile (all rows of a
//     block, TL lanes) in shared memory, applies the zz phase as it loads
//     (sign from the XOR parity of the two index bits, any pair count) and
//     all nkernel rx butterflies in place.
//   pass B (lane_outer_kernel, lane.cuh): a CTA holds 32 rows x 128
//     lanes, computes the complex x @ M with M streamed through shared
//     memory in K chunks, and for K2 writes ks[l] and applies the outer
//     matrix across the D rows {i + k*RB} that the CTA holds together.
// Both passes may run in place: a CTA loads its whole tile before it
// writes, and tiles are disjoint.  K2 is one C entry point that launches
// pass A and pass B for each layer in sequence on the caller's stream (the
// outer stage mixes blocks, so each layer needs a grid-wide dependency).
// Bound at n = 20: the lane matmul (4 real 8192x128x128 GEMMs, 1.07 GFLOP
// a layer) against 67 TFLOP/s float32 outside the tensor cores; the state
// moves 16.8 MB a layer.  No fast-math: sin/cos accuracy matters in f32.

#include "lane.cuh"
#include "rowm.cuh"

namespace {

// pass A tile: RB * TL complex elements, at most 8192 (64 KB of planes)
constexpr int TILE_ELEMS = 8192;

__global__ void __launch_bounds__(THREADS)
zz_rowrx_kernel(const float* xr, const float* xi, float* yr, float* yi,
                const float* __restrict__ zzth, const int* __restrict__ shifts,
                int npairs, const float* __restrict__ th, int nkernel,
                int ltl) {
  extern __shared__ float smem[];
  const int tl = 1 << ltl;
  const int rb = 1 << nkernel;
  const int elems = rb << ltl;
  float* tr = smem;
  float* ti = smem + elems;
  float* zth = smem + 2 * elems;
  int* sh = reinterpret_cast<int*>(zth + npairs);
  for (int k = threadIdx.x; k < npairs; k += blockDim.x) {
    zth[k] = zzth[k];
    sh[2 * k] = shifts[2 * k];
    sh[2 * k + 1] = shifts[2 * k + 1];
  }
  __syncthreads();

  const int tiles = LANES >> ltl;
  const long j = blockIdx.x / tiles;  // row block
  const int lane0 = (blockIdx.x % tiles) << ltl;
  // load + zz phase e^{-i expo/2}, expo = sum_k th_k (1 - 2 (bit_a ^ bit_b))
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int row = e >> ltl;
    const int lane = lane0 + (e & (tl - 1));
    const long off = (j * rb + row) * LANES + lane;
    const unsigned idx = static_cast<unsigned>(off);
    float expo = 0.f;
    for (int k = 0; k < npairs; ++k) {
      const unsigned x = ((idx >> sh[2 * k]) ^ (idx >> sh[2 * k + 1])) & 1u;
      expo += zth[k] * (1.f - 2.f * static_cast<float>(x));
    }
    float s, c;
    sincosf(0.5f * expo, &s, &c);
    const float ar = xr[off], ai = xi[off];
    tr[e] = c * ar + s * ai;
    ti[e] = c * ai - s * ar;
  }
  __syncthreads();
  // rx(th[ql]) on the in-block bit of stride rb >> (ql+1) (most significant
  // first): [[c, -i s], [-i s, c]]
  const int half = elems >> 1;
  for (int ql = 0; ql < nkernel; ++ql) {
    const int ls = nkernel - 1 - ql;  // log2 of the row stride
    float sn, c;
    sincosf(0.5f * th[ql], &sn, &c);
    for (int p = threadIdx.x; p < half; p += blockDim.x) {
      const int pr = p >> ltl;
      const int l = p & (tl - 1);
      const int lo = ((pr >> ls) << (ls + 1)) | (pr & ((1 << ls) - 1));
      const int elo = (lo << ltl) | l;
      const int ehi = elo + (1 << (ls + ltl));
      const float ar = tr[elo], ai = ti[elo], br = tr[ehi], bi = ti[ehi];
      tr[elo] = c * ar + sn * bi;
      ti[elo] = c * ai - sn * br;
      tr[ehi] = c * br + sn * ai;
      ti[ehi] = c * bi - sn * ar;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int row = e >> ltl;
    const int lane = lane0 + (e & (tl - 1));
    const long off = (j * rb + row) * LANES + lane;
    yr[off] = tr[e];
    yi[off] = ti[e];
  }
}

cudaError_t launch_pass_a(const float* xr, const float* xi, float* yr,
                          float* yi, const float* zzth, const int* shifts,
                          int npairs, const float* th, int nkernel, int r,
                          cudaStream_t stream) {
  const int rb = 1 << nkernel;
  int tl = TILE_ELEMS / rb;
  if (tl > LANES) tl = LANES;
  if (tl < 1) tl = 1;
  const int ltl = ilog2(tl);
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(rb) * tl) +
                      sizeof(float) * npairs + sizeof(int) * 2 * npairs;
  cudaError_t err = cudaFuncSetAttribute(
      zz_rowrx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (r / rb) * (LANES / tl);
  zz_rowrx_kernel<<<grid, THREADS, smem, stream>>>(
      xr, xi, yr, yi, zzth, shifts, npairs, th, nkernel, ltl);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tcng_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1.  sr/si, yr/yi: (r, 128) planes (may alias); zzth (npairs);
// shifts (npairs, 2) = (n-1-a, n-1-b); th (nkernel); mr/mi (128, 128)
// lane planes or null; m7r/m7i (R, R) row-kron planes with R = 2^rmx, or
// null with rmx = 0 (then th[0..rmx) is not read).  Returns the first CUDA
// error, 0 on success.
int tcng_zzrx_fwd(const float* sr, const float* si, float* yr, float* yi,
                  const float* zzth, const int* shifts, int npairs,
                  const float* th, int nkernel, const float* mr,
                  const float* mi, const float* m7r, const float* m7i,
                  int rmx, int r, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_pass_a(sr, si, yr, yi, zzth, shifts, npairs,
                                  th + rmx, nkernel - rmx, r, s);
  if (err == cudaSuccess && rmx > 0)  // K13, in place
    err = rowm_apply<false>(yr, yi, nullptr, nullptr, yr, yi, nullptr, nullptr,
                            m7r, m7i, r, nkernel, rmx, s);
  if (err != cudaSuccess || mr == nullptr) return static_cast<int>(err);
  return static_cast<int>(lane_fwd_stage(yr, yi, yr, yi, mr, mi, r, s));
}

// K13's plan at these shapes, for the record: out[0..7) = CW, tiles,
// grid, shared bytes, CTAs an SM, registers, local bytes.
int tcng_rowm_fwd_plan(int rmx, int r, long* out) {
  return static_cast<int>(rowm_apply_plan<false>(rmx, r, out));
}

// K2.  sr/si (r, 128) input planes; ksr/ksi (L, r, 128) residuals;
// yr/yi (r, 128) output; zzth (L, npairs); th (L, nkernel); mor/moi
// (L, D, D) with D = r >> nkernel <= 32; mlr/mli (L, 128, 128).
int tcng_grand_zzrx_fwd(const float* sr, const float* si, float* ksr,
                        float* ksi, float* yr, float* yi, const float* zzth,
                        const int* shifts, int npairs, const float* th,
                        int nkernel, int L, const float* mor,
                        const float* moi, const float* mlr, const float* mli,
                        int r, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rb = 1 << nkernel;
  const int d = r / rb;
  // the one check of the outer dim: the D rows of a block group share a tile
  if (d > B_ROWS) return static_cast<int>(cudaErrorInvalidValue);
  int ni = B_ROWS / d;
  if (ni > rb) ni = rb;
  const size_t plane = static_cast<size_t>(r) * LANES;
  for (int l = 0; l < L; ++l) {
    cudaError_t err = launch_pass_a(
        l == 0 ? sr : yr, l == 0 ? si : yi, yr, yi, zzth + l * npairs,
        shifts, npairs, th + l * nkernel, nkernel, r, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    lane_outer_kernel<true><<<rb / ni, THREADS, 0, s>>>(
        yr, yi, yr, yi, ksr + l * plane, ksi + l * plane,
        mlr + static_cast<size_t>(l) * LANES * LANES,
        mli + static_cast<size_t>(l) * LANES * LANES, mor + l * d * d,
        moi + l * d * d, ni, d, rb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
