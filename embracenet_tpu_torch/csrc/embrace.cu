// Fused EmbraceNet docking + stochastic embracement, forward, for Hopper
// (sm_90a).  Replaces the Pallas TPU kernel
// embracenet_tpu/ops/pallas/embrace.py::_kernel (reached there through
// _fused_fwd_raw and fused_embrace).
//
// What it computes, for every (row r, feature c) of the [B, E] output:
//   d0 = relu(x0[r] . w0[:, c] + b0[c])          x0 [B, D0], w0 [D0, E]
//   d1 = relu(x1[r] . w1[:, c] + b1[c])          x1 [B, D1], w1 [D1, E]
//   u  = top 24 bits of Philox4x32-10(key = seed, counter = (r, c, 0, 0))
//        word 0, times 2^-24: uniform on [0, 1), so p0 = 1 always picks
//        modality 0 and p0 = 0 never does
//   choose[r, c] = u < p0[r]                     (uint8)
//   out[r, c]    = (choose ? d0 : d1) * e_mask[c] (float32)
// The [B, E] docking activations never reach device memory.
//
// Bound at the serving path's shape (B = 4096 rows per micro-batch, D0 = 256,
// D1 = 7936 = cnn.FLAT_MAX, E = 1024):
//   operations 2 * B * (D0 + D1) * E = 68.7 GFLOP;
//   bytes, each input read once and each output written once, ~189 MB in
//   float32 (x1 130 MB, w1 32.5 MB, out 16.8 MB, the rest small);
//   so the float32 path is bound by CUDA-core FP32 (67 TFLOP/s on an H100
//   SXM, ~1.0 ms) and the bf16 path by the tensor cores (989 TFLOP/s,
//   ~0.07 ms); memory alone would take ~0.06 ms.
//
// Design.  This first version is a simple tiled FMA kernel, right before
// fast: one block per 128 x 64 output tile, a K loop inside the block in
// place of the TPU grid's sequential k axis (Hopper blocks run in no order,
// so nothing carries between blocks), x and w tiles staged through shared
// memory with the next tile's global loads issued before the current tile's
// FMAs, and two float32 accumulators (x1 @ w1, then x0 @ w0) of 8 x 4
// outputs per thread.  Operands are float (compute_dtype None) or bf16
// (converted to float on load; products and sums in float32).  The weights
// take a row stride, so sliced views w[:D, :E] need no copy; ragged B, K and
// E edges are masked here, with no padding in the wrapper.  wgmma tensor
// core products fed by TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // rows of the output tile
constexpr int BN = 64;       // features of the output tile
constexpr int BK = 16;       // K depth of one staged tile
constexpr int TM = 8;        // rows per thread
constexpr int TN = 4;        // features per thread
constexpr int THREADS = 256; // (BM / TM) * (BN / TN)
constexpr int A_PAD = 4;     // keeps float4 reads aligned, eases store conflicts

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t philox4x32_10_word0(uint32_t seed,
                                                        uint32_t row,
                                                        uint32_t col) {
  uint32_t c0 = row, c1 = col, c2 = 0u, c3 = 0u;
  uint32_t k0 = seed, k1 = 0u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

// Global -> registers for one BK step.  A tile: BM rows x BK of x, each
// thread 8 consecutive k of one row.  B tile: BK rows x BN of w, each thread
// 4 consecutive features of one row.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, int64_t ldx,
                                          const T* __restrict__ w, int64_t ldw,
                                          int row0, int col0, int k0, int B,
                                          int K, int E, float a[8], float b[4]) {
  const int tid = threadIdx.x;
  const int ar = row0 + (tid >> 1);
  const int ak = k0 + ((tid & 1) << 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j] = (ar < B && ak + j < K) ? to_float(x[(int64_t)ar * ldx + ak + j]) : 0.f;
  }
  const int bk = k0 + (tid >> 4);
  const int bc = col0 + ((tid & 15) << 2);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    b[j] = (bk < K && bc + j < E) ? to_float(w[(int64_t)bk * ldw + bc + j]) : 0.f;
  }
}

__device__ __forceinline__ void store_tile(float (*As)[BM + A_PAD],
                                           float (*Bs)[BN], const float a[8],
                                           const float b[4]) {
  const int tid = threadIdx.x;
  const int ar = tid >> 1, ak = (tid & 1) << 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) As[ak + j][ar] = a[j];
  const int bk = tid >> 4, bc = (tid & 15) << 2;
#pragma unroll
  for (int j = 0; j < 4; ++j) Bs[bk][bc + j] = b[j];
}

// acc[TM][TN] += x[row0:row0+BM, :K] @ w[:K, col0:col0+BN] (this thread's part)
template <typename T>
__device__ __forceinline__ void tile_product(float acc[TM][TN],
                                             const T* __restrict__ x, int64_t ldx,
                                             const T* __restrict__ w, int64_t ldw,
                                             int row0, int col0, int B, int K,
                                             int E, float (*As)[BM + A_PAD],
                                             float (*Bs)[BN]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float a[8], b[4];
  if (K > 0) load_tile(x, ldx, w, ldw, row0, col0, 0, B, K, E, a, b);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store_tile(As, Bs, a, b);
    __syncthreads();
    if (k0 + BK < K) load_tile(x, ldx, w, ldw, row0, col0, k0 + BK, B, K, E, a, b);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float av[TM] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                            a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float bw[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
embrace_fused_fwd_kernel(const T* __restrict__ x0, int64_t ld_x0,
                         const T* __restrict__ x1, int64_t ld_x1,
                         const T* __restrict__ w0, int64_t ld_w0,
                         const T* __restrict__ w1, int64_t ld_w1,
                         const float* __restrict__ b0,
                         const float* __restrict__ b1,
                         const float* __restrict__ p0,
                         const float* __restrict__ e_mask,
                         float* __restrict__ out, uint8_t* __restrict__ choose,
                         int B, int D0, int D1, int E, uint32_t seed) {
  __shared__ __align__(16) float As[BK][BM + A_PAD];
  __shared__ __align__(16) float Bs[BK][BN];
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  float acc1[TM][TN], acc0[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc1[i][j] = acc0[i][j] = 0.f;

  tile_product(acc1, x1, ld_x1, w1, ld_w1, row0, col0, B, D1, E, As, Bs);
  tile_product(acc0, x0, ld_x0, w0, ld_w0, row0, col0, B, D0, E, As, Bs);

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= B) continue;
    const float pr = p0[r];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (c >= E) continue;
      const float d0 = fmaxf(acc0[i][j] + b0[c], 0.f);
      const float d1 = fmaxf(acc1[i][j] + b1[c], 0.f);
      const uint32_t bits = philox4x32_10_word0(seed, (uint32_t)r, (uint32_t)c);
      const float u = (float)(bits >> 8) * (1.0f / 16777216.0f);
      const bool pick0 = u < pr;
      out[(int64_t)r * E + c] = (pick0 ? d0 : d1) * e_mask[c];
      choose[(int64_t)r * E + c] = pick0 ? 1 : 0;
    }
  }
}

template <typename T>
cudaError_t launch(const void* x0, int64_t ld_x0, const void* x1, int64_t ld_x1,
                   const void* w0, int64_t ld_w0, const void* w1, int64_t ld_w1,
                   const float* b0, const float* b1, const float* p0,
                   const float* e_mask, float* out, uint8_t* choose, int B,
                   int D0, int D1, int E, uint32_t seed, cudaStream_t stream) {
  const dim3 grid((B + BM - 1) / BM, (E + BN - 1) / BN);
  embrace_fused_fwd_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x0), ld_x0, static_cast<const T*>(x1), ld_x1,
      static_cast<const T*>(w0), ld_w0, static_cast<const T*>(w1), ld_w1, b0,
      b1, p0, e_mask, out, choose, B, D0, D1, E, seed);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 operands, 1 = bfloat16 operands.  Returns the CUDA
// error code of the launch (0 = success); a bad dtype returns
// cudaErrorInvalidValue.  Launches on `stream` and does not synchronise.
extern "C" int embrace_fused_fwd(int dtype, const void* x0, long long ld_x0,
                                 const void* x1, long long ld_x1,
                                 const void* w0, long long ld_w0,
                                 const void* w1, long long ld_w1,
                                 const float* b0, const float* b1,
                                 const float* p0, const float* e_mask,
                                 float* out, uint8_t* choose, int B, int D0,
                                 int D1, int E, unsigned int seed,
                                 void* stream) {
  if (B <= 0 || E <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x0, ld_x0, x1, ld_x1, w0, ld_w0, w1, ld_w1, b0, b1,
                              p0, e_mask, out, choose, B, D0, D1, E, seed, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x0, ld_x0, x1, ld_x1, w0, ld_w0, w1, ld_w1,
                                      b0, b1, p0, e_mask, out, choose, B, D0,
                                      D1, E, seed, s);
  return (int)cudaErrorInvalidValue;
}
