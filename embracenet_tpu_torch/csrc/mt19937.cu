// A population's initial parameters drawn on the card, bit for bit what
// each trial's CPU torch.Generator draws on the host, for Hopper (sm_90a).
// It replaces no TPU kernel: the JAX package draws its init from its own
// PRNG keys inside XLA.  The port inits every trial from a CPU
// torch.Generator seeded with the trial's init seed (models/layers.py
// torch_uniform_init); drawing that on the host took a second a fit and
// more (92 M numbers at ~9.5 ns each for the 8-trial supernet population),
// and the copies of the drawn tree from pageable memory followed.  This
// kernel runs the same generator on the card and writes the stacked
// leaves in place, so nothing is drawn or copied on the host.
//
// What it computes.  Trial t's stream is MT19937 seeded as torch seeds its
// CPU generator: init_genrand(seed_t & 0xffffffff) (the 624-word state
// from 1812433253 * (s ^ (s >> 30)) + j), then one twist before the first
// word, as torch's mt19937 starts with one word left.  Word k of the
// stream is tempered word k % 624 of the state after k / 624 + 1 twists.
// torch.rand's float32 is the word's low 24 bits times 2^-24 (exact), and
// torch_uniform_init's value is (u * 2 - 1) * bound in float32: u * 2 and
// the - 1 are exact, and the one rounding is the product with the leaf's
// bound, which torch rounds to float32 from its double before it
// multiplies.  The kernel takes each operation alone in round-to-nearest
// (__fmul_rn, __fsub_rn), so nothing is contracted into an FMA.  Leaves
// follow each other in the stream in the order the init draws them; the
// host passes their table (first word, words, destination) in that order.
//
// Bound.  One stream is a serial recurrence: a twist needs the whole state
// of the twist before, so a stream runs in one block, and the card's other
// SMs take the other trials (one block a trial).  A twist is 624 words;
// its stores are 2.5 KB, far below what an SM can write, so the bound is
// the twist's own latency: shared-memory reads, the few integer operations
// and one barrier.
//
// This design.  The state is kept twice in shared memory (old and new), so
// a twist reads only the old state and one barrier a twist suffices.  The
// twist new[i] = new-or-old[i + 397 mod 624] ^ twist(old[i], old[i + 1])
// runs in three dependent phases, words [0, 227), [227, 454), [454, 624):
// a word of phase 2 needs word i - 227 of phase 1, and one of phase 3 word
// i - 227 of phase 2.  Thread i computes word i of all three phases, so the
// value it needs from the phase before is its own, in a register; the last
// word (623) needs new[0] as well, which thread 169 computes again from
// the old state.  Thread i stores its words i, i + 227 and i + 454 of the
// twist: a warp's 32 threads write 32 consecutive floats of one leaf (two
// where a leaf ends), coalesced.  Each of the three words keeps a cursor
// into the leaf table, which only moves forward.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kN = 624;                 // MT19937 state words
constexpr int kM = 397;
constexpr int kLanes = kN - kM;         // 227: the words of phases 1 and 2
constexpr int kLast = kN - 2 * kLanes;  // 170: the words of phase 3
constexpr int kThreads = 256;           // >= kLanes, whole warps
constexpr uint32_t kMatrixA = 0x9908b0dfu;

// One drawn leaf, as the host packs it (three 64-bit words).
struct Leaf {
  long long start;  // its first word in a trial's stream
  long long count;  // its words (the leaf's numel)
  float* dst;       // trial 0's first value; trial t's at dst + t * count
};

__device__ __forceinline__ uint32_t twist(uint32_t u, uint32_t v) {
  return (((u & 0x80000000u) | (v & 0x7fffffffu)) >> 1) ^
         ((v & 1u) ? kMatrixA : 0u);
}

__device__ __forceinline__ uint32_t temper(uint32_t y) {
  y ^= y >> 11;
  y ^= (y << 7) & 0x9d2c5680u;
  y ^= (y << 15) & 0xefc60000u;
  y ^= y >> 18;
  return y;
}

// Where one of a thread's three words goes: the leaf it falls in (end =
// start + count), trial t's destination of the leaf's first word, and the
// leaf's bound for trial t.
struct Cursor {
  int leaf;
  long long start, end;
  float* dst;
  float bound;
};

__device__ __forceinline__ void seek(Cursor& c, long long p, const Leaf* lv,
                                     const float* bd, int n_leaves, int t) {
  while (p >= c.end && c.leaf + 1 < n_leaves) {
    ++c.leaf;
    c.start = lv[c.leaf].start;
    c.end = c.start + lv[c.leaf].count;
    c.dst = lv[c.leaf].dst + (long long)t * lv[c.leaf].count;
    c.bound = bd[c.leaf];
  }
}

__device__ __forceinline__ void put(uint32_t w, long long p, Cursor& c,
                                    const Leaf* lv, const float* bd,
                                    int n_leaves, int t) {
  seek(c, p, lv, bd, n_leaves, t);
  if (p < c.start || p >= c.end) return;  // a word no leaf keeps
  const float u = (float)(temper(w) & 0xffffffu) * 5.9604644775390625e-08f;
  c.dst[p - c.start] = __fmul_rn(__fsub_rn(__fmul_rn(u, 2.0f), 1.0f), c.bound);
}

__global__ void __launch_bounds__(kThreads)
    mt19937_uniform_init_kernel(const Leaf* leaves, const float* bounds,
                                const uint32_t* seeds, int n_leaves,
                                long long words) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* old_s = reinterpret_cast<uint32_t*>(smem);
  uint32_t* new_s = old_s + kN;
  Leaf* lv = reinterpret_cast<Leaf*>(new_s + kN);
  float* bd = reinterpret_cast<float*>(lv + n_leaves);
  const int t = blockIdx.x, i = threadIdx.x;
  for (int j = i; j < n_leaves; j += kThreads) {
    lv[j] = leaves[j];
    bd[j] = bounds[(long long)t * n_leaves + j];
  }
  if (i == 0) {
    uint32_t s = seeds[t];
    old_s[0] = s;
    for (int j = 1; j < kN; ++j) {
      s = 1812433253u * (s ^ (s >> 30)) + (uint32_t)j;
      old_s[j] = s;
    }
  }
  __syncthreads();
  // every cursor starts before leaf 0, so the first seek loads it
  Cursor c0{-1, 0, 0, nullptr, 0.0f}, c1 = c0, c2 = c0;
  for (long long base = 0; base < words; base += kN) {
    if (i < kLanes) {
      const uint32_t n0 = old_s[i + kM] ^ twist(old_s[i], old_s[i + 1]);
      const uint32_t n1 =
          n0 ^ twist(old_s[i + kLanes], old_s[i + kLanes + 1]);
      uint32_t n2 = 0;
      if (i < kLast - 1) {
        n2 = n1 ^ twist(old_s[i + 2 * kLanes], old_s[i + 2 * kLanes + 1]);
      } else if (i == kLast - 1) {  // word 623 wraps round to new[0]
        const uint32_t first = old_s[kM] ^ twist(old_s[0], old_s[1]);
        n2 = n1 ^ twist(old_s[kN - 1], first);
      }
      new_s[i] = n0;
      new_s[i + kLanes] = n1;
      if (i < kLast) new_s[i + 2 * kLanes] = n2;
      put(n0, base + i, c0, lv, bd, n_leaves, t);
      put(n1, base + i + kLanes, c1, lv, bd, n_leaves, t);
      if (i < kLast) put(n2, base + i + 2 * kLanes, c2, lv, bd, n_leaves, t);
    }
    __syncthreads();
    uint32_t* tmp = old_s;
    old_s = new_s;
    new_s = tmp;
  }
}

}  // namespace

// Draw T trials' leaves: leaves [n_leaves] (in stream order, device
// memory), bounds [T, n_leaves] float32 and seeds [T] uint32 (device
// memory), words = the end of the last leaf.  Launches one block a trial
// on `stream` and returns the launch's error code (0: launched).
extern "C" int mt19937_uniform_init(const void* leaves, const float* bounds,
                                    const uint32_t* seeds, int T, int n_leaves,
                                    long long words, void* stream) {
  const size_t smem = 2 * kN * sizeof(uint32_t) + n_leaves * sizeof(Leaf) +
                      n_leaves * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t a = cudaFuncSetAttribute(
        mt19937_uniform_init_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (a != cudaSuccess) return (int)a;
  }
  mt19937_uniform_init_kernel<<<T, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), bounds, seeds, n_leaves, words);
  return (int)cudaGetLastError();
}
