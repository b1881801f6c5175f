// A population's optimizer update in one pass over every leaf and trial,
// for Hopper (sm_90a).  It replaces no TPU kernel: on the TPU, XLA fused
// the JAX package's update (embracenet_tpu/ops/optim.py apply_update,
// vmapped over trials) into one loop a leaf.  The port's plain version
// (ops/optim.py) runs it as separate PyTorch operations over the leaves
// laid end to end: 4 cats, 21 elementwise passes over the [T, N] whole and
// a contiguous copy a leaf, about 62 passes over the parameters a step
// (23.7 GB for the 8-trial supernet population of 95.66 M float32 numbers).
//
// What it computes.  Element for element the plain version's float32
// arithmetic, operation for operation and in its order, each rounded alone
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn: nothing is
// contracted into an FMA, division and root are IEEE's), with the Python
// scalars as torch rounds them to float (0.9, 1.0 - 0.9 taken in double,
// 1e-8).  So on the card it equals the plain version bit for bit:
//   g  = g + wd * p
//   m1 = 0.9 * m + (1 - 0.9) * g
//   v1 = beta2 * v + ((1 - beta2) * g) * g
//   p1 = p - lr * ((cg * g + cm * m1) / (sqrt(v1 * vscale) + 1e-8))
// with lr, wd, beta2, cg, cm and vscale per trial, p the float32 master
// where there is one,
// and m1, v1 and p1 stored in the state's and the params' types (bf16
// rounded to nearest even).  A None gradient reads as zero; a trial whose
// upd is false keeps its old values (params from its master, as there).
// The per-trial coefficients too are the plain version's arithmetic, op
// for op (its torch.where selects a branch): the host takes only the four
// powers (0.96 ** (s 4e-3), 0.96 ** ((s + 1) 4e-3), 0.9 ** s, beta2 ** s
// at the new step s) as torch takes them, and each chunk derives its
// trial's coefficients from them; block 0 writes each trial's new step and
// Nadam momentum schedule.
//
// Bound.  Memory: it reads p (or the master), g, m and v once and writes
// p, m and v (and the master) once, 7 float32 passes (pop8: 2.68 GB, 0.80
// ms at 3.35 TB/s), and computes a dozen operations an element.
//
// This design.  Out of place: the outputs are three (four) fresh buffers
// laid out leaf-major, [leaf 0: T x n0 | leaf 1: T x n1 | ...], each leaf's
// start a multiple of 256 elements, so each new leaf is a contiguous view
// and nothing is concatenated or copied after (the caller keeps a step's
// inputs alive beside its outputs).  The leaf table (each leaf's input
// pointers, its trial's elements, its start in the outputs and its first
// chunk) rides in the kernel's arguments, so a launch copies nothing from
// the host.  A chunk is at most kChunk elements of one trial of one leaf;
// a grid of a few blocks an SM walks the chunks, and a chunk finds its leaf
// by a search of the table's first chunks, then its trial and its start by
// division, so every element of a chunk shares its trial's coefficients.
// Each thread moves 8 elements at a time, 16 bytes a load for bf16 and two
// for float32 (eight independent 16-byte loads in flight for float32
// params and state); elements before the chunk's first 8-element boundary
// in its leaf, after its last, and every element of a chunk whose inputs
// are not 16-byte aligned there take a scalar path.

#include <algorithm>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;            // elements a thread moves at a time
constexpr int kChunk = 8192;       // elements of a chunk (ops/optim.CHUNK)
constexpr int kMaxLeaves = 64;     // leaves it takes (ops/optim.MAX_LEAVES)

// Python's scalars, rounded to float as torch rounds them
constexpr float kB1 = static_cast<float>(0.9);
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kEps = static_cast<float>(1e-8);
constexpr float kB2 = static_cast<float>(0.999);
constexpr float kRmsAlpha = static_cast<float>(0.99);
constexpr int kNadam = 1, kRmsprop = 2;   // ops/optim.NADAM, RMSPROP

struct Leaf {
  const void* p;     // params [T, n] (the source of truth without a master)
  const void* g;     // gradient [T, n]; null: zero
  const void* m;     // first moment [T, n]
  const void* v;     // second moment [T, n]
  const float* w;    // float32 master [T, n]; null without one
  long long off;     // the leaf's first element in the output buffers
  int n;             // elements a trial
  int first;         // the leaf's first chunk
};

struct Args {
  void* p_out;
  void* m_out;
  void* v_out;
  float* w_out;
  // [T] each: the optimizer, rates, the new and the old step, the old
  // momentum schedule and the four powers the host took at the new step
  const int* opt;
  const float *lr, *wd, *step, *step0, *ms, *pt, *pt1, *pb1, *pb2;
  const bool* upd;                 // null: every trial
  float *step_out, *ms_out;        // [T]: the new step and schedule
  int T, n_leaves, n_chunks;
  Leaf leaf[kMaxLeaves];
};

template <typename T> struct Io;

template <> struct Io<float> {
  static __device__ __forceinline__ float get(const float* p) { return *p; }
  static __device__ __forceinline__ void put(float* p, float x) { *p = x; }
  static __device__ __forceinline__ void get8(const float* p, float* x) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
  static __device__ __forceinline__ void put8(float* p, const float* x) {
    reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
};

template <> struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float get(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ void get8(const __nv_bfloat16* p,
                                              float* x) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // bf16 is float32's high half: exact
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void put8(__nv_bfloat16* p,
                                              const float* x) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(x[2 * i]));
      const uint32_t hi =
          __bfloat16_as_ushort(__float2bfloat16_rn(x[2 * i + 1]));
      w[i] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// A trial's coefficients.
struct Coef {
  float lr, wd, b2, omb2, cg, cm, vs, ms_new;
};

// Trial t's coefficients, as ops/optim.apply_update_reference takes them.
__device__ __forceinline__ Coef coef(const Args& a, int t) {
  const bool rms = a.opt[t] == kRmsprop, nadam = a.opt[t] == kNadam;
  const float b2 = rms ? kRmsAlpha : kB2;
  // Nadam momentum schedule (timm legacy Nadam)
  const float mu_t = __fmul_rn(kB1, __fsub_rn(1.0f, __fmul_rn(0.5f, a.pt[t])));
  const float mu_t1 =
      __fmul_rn(kB1, __fsub_rn(1.0f, __fmul_rn(0.5f, a.pt1[t])));
  const float ms_new = __fmul_rn(a.ms[t], mu_t);
  const float ms_next = __fmul_rn(ms_new, mu_t1);
  const float bc1 = __fsub_rn(1.0f, a.pb1[t]);
  const float bc2 = __fsub_rn(1.0f, a.pb2[t]);
  const float nadam_cg =
      __fdiv_rn(__fsub_rn(1.0f, mu_t), __fsub_rn(1.0f, ms_new));
  const float nadam_cm = __fdiv_rn(mu_t1, __fsub_rn(1.0f, ms_next));
  // 1.0 / x is torch's reciprocal (times 1.0): IEEE's 1 / x
  return Coef{a.lr[t], a.wd[t], b2, __fsub_rn(1.0f, b2),
              rms ? 1.0f : (nadam ? nadam_cg : 0.0f),
              rms ? 0.0f : (nadam ? nadam_cm : __frcp_rn(bc1)),
              rms ? 1.0f : __frcp_rn(bc2), ms_new};
}

// One element: the plain version's arithmetic, each operation rounded alone.
__device__ __forceinline__ void update(const Coef& k, float p, float g,
                                       float m, float v, float& p1, float& m1,
                                       float& v1) {
  g = __fadd_rn(g, __fmul_rn(k.wd, p));
  m1 = __fadd_rn(__fmul_rn(kB1, m), __fmul_rn(kOneMinusB1, g));
  v1 = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(__fmul_rn(k.omb2, g), g));
  const float denom = __fadd_rn(__fsqrt_rn(__fmul_rn(v1, k.vs)), kEps);
  const float delta =
      __fdiv_rn(__fadd_rn(__fmul_rn(k.cg, g), __fmul_rn(k.cm, m1)), denom);
  p1 = __fsub_rn(p, __fmul_rn(k.lr, delta));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One chunk's elements [0, len), from e0 in their leaf: a trial's live
// update, or its old values where it is frozen (live false: g unread).
template <typename P, typename S, bool kMaster>
__device__ __forceinline__ void run_chunk(const Args& a, const Leaf& L,
                                          long long e0, int len,
                                          const Coef& k, bool live) {
  const P* p = static_cast<const P*>(L.p) + e0;
  const float* w = kMaster ? L.w + e0 : nullptr;
  const P* g = (live && L.g) ? static_cast<const P*>(L.g) + e0 : nullptr;
  const S* m = static_cast<const S*>(L.m) + e0;
  const S* v = static_cast<const S*>(L.v) + e0;
  P* po = static_cast<P*>(a.p_out) + L.off + e0;
  S* mo = static_cast<S*>(a.m_out) + L.off + e0;
  S* vo = static_cast<S*>(a.v_out) + L.off + e0;
  float* wo = kMaster ? a.w_out + L.off + e0 : nullptr;

  // the vector body starts at the chunk's first 8-element boundary in its
  // leaf, where the outputs are aligned; the inputs must be there too
  int head = static_cast<int>((kVec - (e0 & (kVec - 1))) & (kVec - 1));
  head = head < len ? head : len;
  bool vec = aligned16(m + head) && aligned16(v + head) &&
             (g == nullptr || aligned16(g + head)) &&
             (kMaster ? aligned16(w + head) : aligned16(p + head));
  const int body = vec ? (len - head) / kVec * kVec : 0;
  if (!vec) head = len;

  auto one = [&](int i) {
    const float pi = kMaster ? w[i] : Io<P>::get(p + i);
    const float mi = Io<S>::get(m + i), vi = Io<S>::get(v + i);
    float p1 = pi, m1 = mi, v1 = vi;
    if (live) update(k, pi, g ? Io<P>::get(g + i) : 0.0f, mi, vi, p1, m1, v1);
    Io<P>::put(po + i, p1);
    Io<S>::put(mo + i, m1);
    Io<S>::put(vo + i, v1);
    if (kMaster) wo[i] = p1;
  };
  // the scalar elements: the head, then the tail after the body
  const int scalars = len - body;
  for (int j = threadIdx.x; j < scalars; j += kThreads) {
    one(j < head ? j : j + body);
  }
  for (int i = head + threadIdx.x * kVec; i < head + body;
       i += kThreads * kVec) {
    float pi[kVec], gi[kVec], mi[kVec], vi[kVec];
    if (kMaster) {
      Io<float>::get8(w + i, pi);
    } else {
      Io<P>::get8(p + i, pi);
    }
    if (g) {
      Io<P>::get8(g + i, gi);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) gi[e] = 0.0f;
    }
    Io<S>::get8(m + i, mi);
    Io<S>::get8(v + i, vi);
    if (live) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        update(k, pi[e], gi[e], mi[e], vi[e], pi[e], mi[e], vi[e]);
      }
    }
    Io<P>::put8(po + i, pi);
    Io<S>::put8(mo + i, mi);
    Io<S>::put8(vo + i, vi);
    if (kMaster) Io<float>::put8(wo + i, pi);
  }
}

template <typename P, typename S, bool kMaster>
__global__ void __launch_bounds__(kThreads)
    optim_update_kernel(const __grid_constant__ Args a) {
  if (blockIdx.x == 0) {
    for (int t = threadIdx.x; t < a.T; t += kThreads) {
      const bool live = a.upd == nullptr || a.upd[t];
      a.step_out[t] = live ? a.step[t] : a.step0[t];
      a.ms_out[t] = live ? coef(a, t).ms_new : a.ms[t];
    }
  }
  for (int c = blockIdx.x; c < a.n_chunks; c += gridDim.x) {
    // the chunk's leaf: the last whose first chunk is at or before c
    int lo = 0, hi = a.n_leaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (a.leaf[mid].first <= c) lo = mid; else hi = mid - 1;
    }
    const Leaf& L = a.leaf[lo];
    const int per_trial = (L.n + kChunk - 1) / kChunk;
    const int t = (c - L.first) / per_trial;
    const int start = (c - L.first - t * per_trial) * kChunk;
    const int len = min(kChunk, L.n - start);
    const Coef k = coef(a, t);
    const bool live = a.upd == nullptr || a.upd[t];
    run_chunk<P, S, kMaster>(a, L, static_cast<long long>(t) * L.n + start,
                                len, k, live);
  }
}

template <typename P, typename S, bool kMaster>
int launch(const Args& a, cudaStream_t stream) {
  static int per_sm = 0;   // resident blocks an SM, asked once
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, optim_update_kernel<P, S, kMaster>, kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = std::min(a.n_chunks, sms * std::max(per_sm, 1));
  if (grid > 0) {
    optim_update_kernel<P, S, kMaster><<<grid, kThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename P, typename S>
int with_master(const Args& a, bool master, cudaStream_t stream) {
  return master ? launch<P, S, true>(a, stream)
                : launch<P, S, false>(a, stream);
}

template <typename P>
int with_state(const Args& a, int s_dtype, bool master, cudaStream_t stream) {
  return s_dtype ? with_master<P, __nv_bfloat16>(a, master, stream)
                 : with_master<P, float>(a, master, stream);
}

}  // namespace

// One launch over n_leaves (at most kMaxLeaves) leaves of T trials.
// table [n_leaves, 8] int64, in host memory: each leaf's p, g (0: zero), m,
// v and w (0: no master) device pointers, its first element in the output
// buffers, its elements a trial and its first chunk.  trials [13] int64,
// in host memory: device pointers to [T] opt (int32), lr, wd, step, step0,
// ms, pt, pt1, pb1, pb2 (float32), upd (bool; 0: every trial), and the
// outputs step_out and ms_out (float32).  Outputs p_out, m_out, v_out and
// w_out (null without a master) in device memory.  Dtype codes of the
// params (and their gradients) and of the state: 0 float32, 1 bfloat16.
// Launches on `stream`; returns the launch's error code (0: launched; -1:
// too many leaves).
extern "C" int optim_update(const long long* table, int n_leaves,
                            int n_chunks, const long long* trials, int T,
                            void* p_out, void* m_out, void* v_out,
                            void* w_out, int p_dtype, int s_dtype,
                            void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves) return -1;
  auto f = [&](int i) { return reinterpret_cast<const float*>(trials[i]); };
  Args a{};
  a.p_out = p_out;
  a.m_out = m_out;
  a.v_out = v_out;
  a.w_out = static_cast<float*>(w_out);
  a.opt = reinterpret_cast<const int*>(trials[0]);
  a.lr = f(1);
  a.wd = f(2);
  a.step = f(3);
  a.step0 = f(4);
  a.ms = f(5);
  a.pt = f(6);
  a.pt1 = f(7);
  a.pb1 = f(8);
  a.pb2 = f(9);
  a.upd = reinterpret_cast<const bool*>(trials[10]);
  a.step_out = reinterpret_cast<float*>(trials[11]);
  a.ms_out = reinterpret_cast<float*>(trials[12]);
  a.T = T;
  a.n_leaves = n_leaves;
  a.n_chunks = n_chunks;
  for (int l = 0; l < n_leaves; ++l) {
    const long long* r = table + 8 * l;
    a.leaf[l] = Leaf{reinterpret_cast<const void*>(r[0]),
                     reinterpret_cast<const void*>(r[1]),
                     reinterpret_cast<const void*>(r[2]),
                     reinterpret_cast<const void*>(r[3]),
                     reinterpret_cast<const float*>(r[4]), r[5],
                     static_cast<int>(r[6]), static_cast<int>(r[7])};
  }
  const bool master = a.w_out != nullptr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p_dtype ? with_state<__nv_bfloat16>(a, s_dtype, master, s)
                 : with_state<float>(a, s_dtype, master, s);
}
