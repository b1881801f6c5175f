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
//
// The seed comes by value or, where the caller drew it on the device (a
// training step draws it from the step's torch.Generator), through a
// pointer to one int64 in device memory that every thread reads: the host
// never waits for the draw.  This takes the place of the TPU kernel's
// scalar-prefetched seed.
//
// The second kernel, embrace_fused_fwd_fulle below, replaces _kernel_fulle
// (reached there through _fused_fwd_fulle): the same function, blocked so
// that one block owns BM rows and the whole E width.

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

// u for (row r, feature c): the top 24 bits of Philox word 0, times 2^-24
__device__ __forceinline__ float draw_u(uint32_t key, int r, int c) {
  const uint32_t bits = philox4x32_10_word0(key, (uint32_t)r, (uint32_t)c);
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
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
                         int B, int D0, int D1, int E, uint32_t seed,
                         const long long* __restrict__ seed_dev) {
  __shared__ __align__(16) float As[BK][BM + A_PAD];
  __shared__ __align__(16) float Bs[BK][BN];
  const uint32_t key = seed_dev ? (uint32_t)(*seed_dev) : seed;
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
      const bool pick0 = draw_u(key, r, c) < pr;
      out[(int64_t)r * E + c] = (pick0 ? d0 : d1) * e_mask[c];
      choose[(int64_t)r * E + c] = pick0 ? 1 : 0;
    }
  }
}

// ---------------------------------------------------------------------------
// Full-E blocking: replaces embracenet_tpu/ops/pallas/embrace.py::_kernel_fulle.
//
// The TPU kernel keeps a 256-row x E f32 accumulator in VMEM so that x1
// streams from memory once (the tiled kernel above re-reads each x1 row
// once per 64-feature tile, E / 64 = 16 times at E = 1024).  A Hopper block
// cannot hold 256 x 1024 accumulators, so here one block owns BM = 8 rows
// and all of E (in passes of 1024 features), with the sums in registers:
// thread t owns features e0 + t + 256 j (j < 4) of all 8 rows, 2 x 32
// float32 accumulators (x1 @ w1, then x0 @ w0).  Each staged 8 x 32 x1 tile
// is used for every E column before the next K step, so x1 is read from
// memory once.  The weights are not shared between threads (each feature
// column belongs to one thread), so they are read straight from global
// memory, coalesced across the warp, and every block reads all of w1
// (L2-resident at these sizes: 32.5 MB float32, 16 MB bf16).
//
// Sums run over k in order with fmaf from 0, as in the tiled kernel, and
// the draw is the same Philox(seed, row, feature), so both kernels give
// the same out and choose bit for bit for the same seed.  The TPU reseeded
// its PRNG per B-block (seed + i), so its two kernels drew differently.
//
// Occupancy: ceil(B / 8) blocks, 13 at B = 100, where 132 SMs are
// available; 512 at B = 4096.  Bound as the tiled kernel's (operations in
// float32, bytes or operations in bf16 depending on B); this simple
// version is bound in practice by the w1 stream each block reads from L2.
// ---------------------------------------------------------------------------
namespace fulle {

constexpr int BM = 8;               // rows per block
constexpr int THREADS = 256;
constexpr int CPT = 4;              // features per thread in one pass
constexpr int EC = THREADS * CPT;   // features per pass (1024)
constexpr int BK = THREADS / BM;    // K depth of a staged x tile (32)

template <typename T>
__device__ __forceinline__ float load_x(const T* __restrict__ x, int64_t ldx,
                                        int r, int k, int B, int K) {
  return (r < B && k < K) ? to_float(x[(int64_t)r * ldx + k]) : 0.f;
}

// acc[i][j] = sum over k of x[row0 + i, k] * w[k, e0 + tid + j * THREADS]
template <typename T>
__device__ __forceinline__ void rows_product(float acc[BM][CPT],
                                             const T* __restrict__ x,
                                             int64_t ldx,
                                             const T* __restrict__ w,
                                             int64_t ldw, int row0, int e0,
                                             int B, int K, int E,
                                             float (*xs)[BK]) {
  const int tid = threadIdx.x;
  const int xr = tid / BK, xk = tid % BK;
#pragma unroll
  for (int i = 0; i < BM; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  float xv = load_x(x, ldx, row0 + xr, xk, B, K);
  for (int k0 = 0; k0 < K; k0 += BK) {
    xs[xr][xk] = xv;
    __syncthreads();
    if (k0 + BK < K) xv = load_x(x, ldx, row0 + xr, k0 + BK + xk, B, K);
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const int k = k0 + kk;
      float wv[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = e0 + tid + j * THREADS;
        wv[j] = (k < K && c < E) ? to_float(w[(int64_t)k * ldw + c]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        const float a = xs[i][kk];
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a, wv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
embrace_fulle_kernel(const T* __restrict__ x0, int64_t ld_x0,
                     const T* __restrict__ x1, int64_t ld_x1,
                     const T* __restrict__ w0, int64_t ld_w0,
                     const T* __restrict__ w1, int64_t ld_w1,
                     const float* __restrict__ b0,
                     const float* __restrict__ b1,
                     const float* __restrict__ p0,
                     const float* __restrict__ e_mask,
                     float* __restrict__ out, uint8_t* __restrict__ choose,
                     int B, int D0, int D1, int E, uint32_t seed,
                     const long long* __restrict__ seed_dev) {
  __shared__ float xs[BM][BK];
  const uint32_t key = seed_dev ? (uint32_t)(*seed_dev) : seed;
  const int row0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  for (int e0 = 0; e0 < E; e0 += EC) {
    float acc1[BM][CPT], acc0[BM][CPT];
    rows_product(acc1, x1, ld_x1, w1, ld_w1, row0, e0, B, D1, E, xs);
    rows_product(acc0, x0, ld_x0, w0, ld_w0, row0, e0, B, D0, E, xs);
#pragma unroll
    for (int i = 0; i < BM; ++i) {
      const int r = row0 + i;
      if (r >= B) break;
      const float pr = p0[r];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = e0 + tid + j * THREADS;
        if (c >= E) continue;
        const float d0 = fmaxf(acc0[i][j] + b0[c], 0.f);
        const float d1 = fmaxf(acc1[i][j] + b1[c], 0.f);
        const bool pick0 = draw_u(key, r, c) < pr;
        out[(int64_t)r * E + c] = (pick0 ? d0 : d1) * e_mask[c];
        choose[(int64_t)r * E + c] = pick0 ? 1 : 0;
      }
    }
  }
}

}  // namespace fulle

template <typename T, bool FULLE>
cudaError_t launch(const void* x0, int64_t ld_x0, const void* x1, int64_t ld_x1,
                   const void* w0, int64_t ld_w0, const void* w1, int64_t ld_w1,
                   const float* b0, const float* b1, const float* p0,
                   const float* e_mask, float* out, uint8_t* choose, int B,
                   int D0, int D1, int E, uint32_t seed,
                   const long long* seed_dev, cudaStream_t stream) {
  const T* tx0 = static_cast<const T*>(x0);
  const T* tx1 = static_cast<const T*>(x1);
  const T* tw0 = static_cast<const T*>(w0);
  const T* tw1 = static_cast<const T*>(w1);
  if constexpr (FULLE) {
    const dim3 grid((B + fulle::BM - 1) / fulle::BM);
    fulle::embrace_fulle_kernel<T><<<grid, fulle::THREADS, 0, stream>>>(
        tx0, ld_x0, tx1, ld_x1, tw0, ld_w0, tw1, ld_w1, b0, b1, p0, e_mask,
        out, choose, B, D0, D1, E, seed, seed_dev);
  } else {
    const dim3 grid((B + BM - 1) / BM, (E + BN - 1) / BN);
    embrace_fused_fwd_kernel<T><<<grid, THREADS, 0, stream>>>(
        tx0, ld_x0, tx1, ld_x1, tw0, ld_w0, tw1, ld_w1, b0, b1, p0, e_mask,
        out, choose, B, D0, D1, E, seed, seed_dev);
  }
  return cudaGetLastError();
}

template <bool FULLE>
int dispatch(int dtype, const void* x0, long long ld_x0, const void* x1,
             long long ld_x1, const void* w0, long long ld_w0, const void* w1,
             long long ld_w1, const float* b0, const float* b1,
             const float* p0, const float* e_mask, float* out,
             uint8_t* choose, int B, int D0, int D1, int E, unsigned int seed,
             const long long* seed_dev, void* stream) {
  if (B <= 0 || E <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float, FULLE>(x0, ld_x0, x1, ld_x1, w0, ld_w0, w1,
                                     ld_w1, b0, b1, p0, e_mask, out, choose,
                                     B, D0, D1, E, seed, seed_dev, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, FULLE>(x0, ld_x0, x1, ld_x1, w0, ld_w0,
                                             w1, ld_w1, b0, b1, p0, e_mask,
                                             out, choose, B, D0, D1, E, seed,
                                             seed_dev, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 operands, 1 = bfloat16 operands.  seed_dev: null, or a
// device pointer to one int64 whose low 32 bits replace `seed`.  Returns the
// CUDA error code of the launch (0 = success); a bad dtype returns
// cudaErrorInvalidValue.  Launches on `stream` and does not synchronise.
#define EMBRACE_ENTRY(NAME, FULLE)                                            \
  extern "C" int NAME(int dtype, const void* x0, long long ld_x0,             \
                      const void* x1, long long ld_x1, const void* w0,        \
                      long long ld_w0, const void* w1, long long ld_w1,       \
                      const float* b0, const float* b1, const float* p0,      \
                      const float* e_mask, float* out, uint8_t* choose,       \
                      int B, int D0, int D1, int E, unsigned int seed,        \
                      const long long* seed_dev, void* stream) {              \
    return dispatch<FULLE>(dtype, x0, ld_x0, x1, ld_x1, w0, ld_w0, w1, ld_w1, \
                           b0, b1, p0, e_mask, out, choose, B, D0, D1, E,     \
                           seed, seed_dev, stream);                           \
  }

EMBRACE_ENTRY(embrace_fused_fwd, false)
EMBRACE_ENTRY(embrace_fused_fwd_fulle, true)
