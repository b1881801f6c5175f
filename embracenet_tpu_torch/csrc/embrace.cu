// Fused EmbraceNet docking + stochastic embracement, forward, for Hopper
// (sm_90a).  Replaces the Pallas TPU kernel
// embracenet_tpu/ops/pallas/embrace.py::_kernel (reached there through
// _fused_fwd_raw and fused_embrace), with the leading trial axis that
// Pallas' batching rule gives it under the JAX engine's jax.vmap over a
// population: one launch computes T trials, trial t from its own operands
// and its own seed.
//
// What it computes, for every trial t and (row r, feature c) of its [B, E]
// output (all operands below are trial t's: x0 [T, B, D0], w0 [T, D0, E],
// b0, b1, e_mask [T, E], p0 [T, B], out and choose [T, B, E]):
//   d0 = relu(x0[r] . w0[:, c] + b0[c])          x0 [B, D0], w0 [D0, E]
//   d1 = relu(x1[r] . w1[:, c] + b1[c])          x1 [B, D1], w1 [D1, E]
//   u  = top 24 bits of Philox4x32-10(key = seed of trial t,
//        counter = (row_base + r, c, 0, 0)) word 0, times 2^-24: uniform on
//        [0, 1), so p0 = 1 always picks modality 0 and p0 = 0 never does
//        (row_base: the batch row of x0's row 0, for a shard of a batch)
//   choose[r, c] = u < p0[r]                     (uint8)
//   out[r, c]    = (choose ? d0 : d1) * e_mask[c] (float32)
// The [B, E] docking activations never reach device memory.  A trial's
// draw does not depend on the other trials: its choose is bit for bit that
// of a launch on its operands alone.
//
// The trial axis.  It is the outermost coordinate of every operand: each is
// read through a rank-3 TMA tensor map (columns, rows, trials), so no tile
// crosses from one trial into the next and the ragged row edge zero-fills
// per trial.  Grid z runs over T x row tiles (z = t * row_tiles + row
// tile), the clusters along x (split K) or y (full E) never span trials,
// and the epilogue offsets b0, b1, e_mask, p0, out, choose and the seed by
// the trial.  The plan (ops/embrace.py) is one trial's, whatever T: its
// tile rows and K split fix the order in which a trial's sums are taken, so
// a trial's out is bit for bit that of its launch alone, and at T = 8, B =
// 100 the grid runs 8 x 128 CTAs in several waves.
//
// Bound.  Operations 2 * B * (D0 + D1) * E; bytes, each input read once and
// each output written once: x0, x1, w0, w1 in the operand type, out float32,
// choose uint8.  At the serving shape (B = 4096, D0 = 256, D1 = 7936 =
// cnn.FLAT_MAX, E = 1024) that is 68.7 GFLOP and ~189 MB in float32: bound
// by CUDA-core FP32 (67 TFLOP/s on an H100 SXM, 1.03 ms); with bf16
// operands ~110 MB, bound by the tensor cores (989 TFLOP/s, 0.07 ms).  At
// the training batch (B = 100 or 200, same widths) the float32 call is
// still bound by operations (0.025 / 0.050 ms) and the bf16 call by the
// 16 MB of w1 (~0.006 ms).
//
// What bound the first design (a CUDA-core FMA kernel, one block
// per 128 x 64 output tile, one register-staged prefetch of a 16-deep K
// tile): bf16 operands were converted to float on load, so they ran at the
// float32 rate (2.8 ms against 0.07 ms); at B = 100 it launched 16 blocks
// on 132 SMs, each walking all of K = 7936 alone; and its float32 mainloop
// reached 39 % of the FP32 peak.
//
// This design:
//   * bf16 operands: wgmma.mma_async m64n128k16 with float32 accumulators
//     in registers, one consumer warpgroup per 64 rows of a 64 x 128 or
//     128 x 128 output tile, one group of products kept in flight.  A (x
//     tile) is K-major, B (w tile) MN-major: w is [D, E] row-major, so the
//     transpose bit is set and a k step of 16 advances the B descriptor by
//     16 rows.
//   * float32 operands stay in full float32 on the CUDA cores (the
//     reference multiplies at Precision.HIGHEST; TF32 would keep ~3
//     digits): 8 x 8 outputs a thread, 256 threads on a 128 x 128 tile, or
//     two groups of 128 threads on a 64 x 128 tile that take alternate
//     stages of the ring (so 8 warps compute where the training batches
//     leave one CTA an SM); float4 shared-memory reads free of bank
//     conflicts (x rows arrive 128B-swizzled, w rows linear).
//   * Both types: a ring of 3 (bf16 64-row tiles) or 4 shared-memory
//     stages filled by TMA (cp.async.bulk.tensor.2d), one producer warp,
//     mbarriers for full and empty stages.  TMA's out-of-bounds zero fill
//     takes the ragged B, K and E edges; the weights' row stride goes into
//     the tensor map, so the model's dock*_w[:D, :E] views need no copy.
//     x0 @ w0 runs first through the same ring and registers; its sums are
//     parked in shared memory while x1 @ w1 takes the registers.
//   * Split K across a thread-block cluster of `split` CTAs (1 to 8, chosen
//     by ops/embrace.py::launch_plan) when the output tiles alone would
//     leave most of the 132 SMs idle, as at B = 100: the K tiles of x0 @ w0
//     and then of x1 @ w1 form one list, CTA rank q takes its q-th
//     contiguous share, keeps its partial sums in its own shared memory,
//     and after a cluster barrier each rank adds one slice of the tile's
//     sums over ranks 0, 1, ..., split - 1 (and groups), in that order,
//     through distributed shared memory, and runs the epilogue on that
//     slice: once per element, no atomics.  A cluster's CTAs must share one
//     GPC, so the plan asks CUDA how many clusters fit at once and keeps
//     the grid to one wave (bf16 64-row tiles fit twice on an SM: 30
//     clusters of 8; float32 ones once: 15 of 8 but 17 of 6 on an H100).
//   * The epilogue (bias, ReLU, the draw, the select, e_mask) runs on the
//     accumulator's fragment layout and writes out and choose.
// Sums are taken in a fixed order for a given launch plan, so a seed
// repeats bit for bit; the plan depends only on the shapes, the operand
// type and the card, so the same call on the same card repeats too.
//
// The seed comes by value or, where the caller drew it on the device (a
// training step draws it from the step's torch.Generator), through a
// pointer to one int64 in device memory that every thread reads: the host
// never waits for the draw.  This takes the place of the TPU kernel's
// scalar-prefetched seed.
//
// The full-E kernel, entry embrace_fused_fwd_fulle, replaces
// embracenet_tpu/ops/pallas/embrace.py::_kernel_fulle (reached there through
// _fused_fwd_fulle): the same function with all of E in one block, so that
// x1 streams once rather than once per feature tile.  A Hopper CTA cannot
// hold a 256 x 1024 accumulator; what the TPU kernel wanted is had here by
// a thread-block cluster that spans E.  It is the tiled kernel's own
// mainloop and epilogue (template flag FULLE): rank q of a cluster of c
// CTAs owns column tile cluster_index * c + q of one row tile and walks all
// K tiles of x0 @ w0, then of x1 @ w1, in the unsplit order.  Each CTA
// loads its own w tiles; stage t's x tile is issued once, by rank t % c,
// as a TMA multicast into every rank's ring, so each full barrier expects
// its w bytes plus the whole x tile.  A stage is refilled in all ranks at
// once, so its empty barrier counts the consumer warps of every rank (lane
// q of each warp arrives remotely on rank q's barrier); the cluster syncs
// after the barriers' init and before any CTA leaves.
//   What bounds it: per k step a full-E cluster loads c w tiles and one x
// tile instead of c of each, 0.56x the tiled kernel's L2 -> SM bytes at c
// = 8 (0.75x at c = 2).  On an H100 that buys no time: with every cluster
// width in one wave (B = 1920, 128-row tiles) c = 8 is ~18 % slower than c
// = 1 in bf16 and level in float32 (tools/torch_embrace_ab.py --widths).
// Both kernels are bound inside the SM (a bf16 128 x 128 tile at about
// half an SM's tensor peak; float32 by the FFMA mainloop's shared-memory
// reads), and multicast adds a cost: a stage refills only once every rank
// released it, so the slowest rank and one remote hop pace each stage.
//   Plan (ops/embrace.py::fulle_plan): the tiled kernel's tile rows (128
// only where 128-row tiles alone fill the SMs), and the c dividing the
// column tiles that takes the fewest waves by CUDA's cluster occupancy
// query, then the widest.  No split K: at B = 100 it runs 16 CTAs, each
// walking all of K, as the TPU kernel ran one block there.
//   Both kernels draw the same Philox stream, so they choose identically
// for a seed; where both plans give the same tile rows and the tiled plan
// does not split K they run the same instructions in the same K order and
// out is equal bit for bit, elsewhere within rounding.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

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

// ---------------------------------------------------------------------------
// PTX: shared-memory addresses, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// arrive once and expect `bytes` more from TMA before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// arrive once on the mbarrier at `bar`'s offset in the shared memory of CTA
// `cta` of this cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(cta)
      : "memory");
}

// the two halves of a cluster barrier: every thread of every CTA arrives,
// then waits for all of them
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// wait until the phase of parity `parity` has completed; a phase that never
// completes (a lost copy) traps after ~2e10 cycles instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > 20000000000ll) __trap();
  }
}

// one box of `map` at (c0 = column, c1 = row, c2 = trial) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// the same box into the same shared-memory offset of every CTA of the
// cluster in `mask`; each completes its bytes on its own mbarrier at
// `bar`'s offset
__device__ __forceinline__ void tma_load_multicast(void* dst,
                                                   const CUtensorMap* map,
                                                   uint64_t* bar, int c0,
                                                   int c1, int c2,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.multicast::cluster [%0], [%1, {%4, %5, %6}], [%2], %3;" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "h"(mask),
      "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] (K-major) * B[16 x 128] (MN-major), bf16 in,
// float32 accumulators in the warpgroup's fragment layout
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// Tile shapes and mainloops.  A stage holds an A tile (BM rows x BK of x,
// K-major, 128B-swizzled: each row is 128 bytes) and a B tile (BK rows x BN
// features of w, loaded as BN / BOX_N boxes of BOX_N features).
// ---------------------------------------------------------------------------

// bf16 operands: WG consumer warpgroups, 64 rows each, wgmma
template <int WG>
struct Bf16Tiles {
  using T = __nv_bfloat16;
  static constexpr CUtensorMapDataType DT = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // 64-row tiles: 3 stages and <= 112 registers, so that two CTAs fit on
  // an SM and 30 clusters of 8 fit at once
  static constexpr int BM = 64 * WG, BN = 128, BK = 64, STAGES = WG == 1 ? 3 : 4;
  static constexpr int MIN_CTAS = WG == 1 ? 2 : 1;
  static constexpr int CONSUMERS = 128 * WG;
  static constexpr int GROUPS = 1;  // consumer groups splitting the CTA's K tiles
  static constexpr int LAG = 1;  // a stage is free once the next one's wgmma runs
  static constexpr int NACC = 64;   // accumulators a thread, per product
  static constexpr int BOX_N = 64;  // 128 bytes: the swizzle span
  static constexpr CUtensorMapSwizzle W_SWIZZLE = CU_TENSOR_MAP_SWIZZLE_128B;
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BK * BN * 2;

  // issue this stage's products; on return the previous stage's are done
  __device__ static void mma(float (&acc)[NACC], const uint8_t* a,
                             const uint8_t* b, int tid) {
    const uint32_t sa = smem_u32(a) + (tid / 128) * 64 * BK * 2;
    const uint32_t sb = smem_u32(b);
    wgmma_fence_operands(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: +32 bytes along the swizzled row; B: +16 rows of 128 bytes.
      // A's 8-row groups lie 1024 bytes apart; B's 8-row K groups too, and
      // its two 64-feature boxes BOX_N * BK * 2 bytes apart.
      wgmma_m64n128k16(acc, wgmma_desc(sa + kk * 32, 16, 1024),
                       wgmma_desc(sb + kk * 16 * 128, BOX_N * BK * 2, 1024));
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
  }

  // wait for every product issued: acc holds the sums
  __device__ static void drain(float (&acc)[NACC]) {
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    wgmma_fence_operands(acc);
  }

  // element i of consumer thread tid -> (row, feature) in the tile
  __device__ static void coords(int i, int tid, int& r, int& c) {
    const int t = tid & 127, l = t & 31;
    r = (tid >> 7) * 64 + (t >> 5) * 16 + (l >> 2) + 8 * ((i >> 1) & 1);
    c = (i >> 2) * 8 + (l & 3) * 2 + (i & 1);
  }
};

// float32 operands: G groups of GT consumer threads, 8 x 8 outputs a
// thread, FFMA.  Thread (ty, tx) of a group, ty < GT / 16, owns rows
// ty + (GT / 16) i and features tx * 4 + j, 64 + tx * 4 + j: a warp reads
// two rows of A (different swizzle phases) and 16 consecutive float4 of B,
// so no read conflicts.  The groups take alternate stages of the ring, so
// each sums its own share of the CTA's K tiles and a CTA runs G times the
// warps its tile alone would give: 2 groups of 128 threads on a 64-row
// tile (8 consumer warps where the training batches leave one CTA an SM),
// 1 group of 256 on a 128-row tile.
template <int GT, int G = 1>
struct F32Tiles {
  using T = float;
  static constexpr CUtensorMapDataType DT = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static constexpr int RS = GT / 16;  // row stride of a thread's rows
  static constexpr int BM = 8 * RS, BN = 128, BK = 32;
  static constexpr int STAGES = 4;
  static constexpr int MIN_CTAS = 1;
  static constexpr int CONSUMERS = GT * G;
  static constexpr int GROUPS = G;
  static constexpr int LAG = 0;  // the FMAs are done when mma returns
  static constexpr int NACC = 64;
  static constexpr int BOX_N = 128;
  static constexpr CUtensorMapSwizzle W_SWIZZLE = CU_TENSOR_MAP_SWIZZLE_NONE;
  static constexpr int A_BYTES = BM * BK * 4, B_BYTES = BK * BN * 4;

  __device__ static void mma(float (&acc)[NACC], const uint8_t* a,
                             const uint8_t* b, int tid) {
    const int lane = tid & 31, tx = lane & 15, ty = (tid >> 5) * 2 + (lane >> 4);
    const float* bs = reinterpret_cast<const float*>(b) + tx * 4;
#pragma unroll
    for (int kq = 0; kq < BK / 4; ++kq) {
      float av[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // 16-byte chunk kq of row ty + RS i sits at chunk kq ^ (row % 8)
        const float4 v = *reinterpret_cast<const float4*>(
            a + (ty + RS * i) * 128 + ((kq ^ (ty & 7)) << 4));
        av[i][0] = v.x, av[i][1] = v.y, av[i][2] = v.z, av[i][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 lo = *reinterpret_cast<const float4*>(bs + (kq * 4 + kk) * BN);
        const float4 hi = *reinterpret_cast<const float4*>(bs + (kq * 4 + kk) * BN + 64);
        const float bw[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i * 8 + j] = fmaf(av[i][kk], bw[j], acc[i * 8 + j]);
      }
    }
  }

  __device__ static void drain(float (&)[NACC]) {}

  __device__ static void coords(int i, int tid, int& r, int& c) {
    const int lane = tid & 31, tx = lane & 15, ty = (tid >> 5) * 2 + (lane >> 4);
    const int j = i & 7;
    r = ty + RS * (i >> 3);
    c = (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
  }
};

struct Epilogue {
  const float* b0;
  const float* b1;
  const float* p0;
  const float* e_mask;
  float* out;
  uint8_t* choose;
  int B, E;
  uint32_t seed;
  const long long* seed_dev;  // null, or one int64 key per trial
  int row_base;  // batch row of this launch's row 0 (a shard's first row)

  // trial t's operands and key
  __device__ Epilogue trial(int t) const {
    Epilogue e = *this;
    const int64_t be = (int64_t)B * E;
    e.b0 += (int64_t)t * E;
    e.b1 += (int64_t)t * E;
    e.e_mask += (int64_t)t * E;
    e.p0 += (int64_t)t * B;
    e.out += t * be;
    e.choose += t * be;
    if (e.seed_dev) e.seed_dev += t;
    return e;
  }
};

__device__ __forceinline__ void finish(const Epilogue& ep, uint32_t key, int r,
                                       int c, float a0, float a1) {
  if (r >= ep.B || c >= ep.E) return;
  const float d0 = fmaxf(a0 + ep.b0[c], 0.f);
  const float d1 = fmaxf(a1 + ep.b1[c], 0.f);
  const bool pick0 = draw_u(key, ep.row_base + r, c) < ep.p0[r];
  const int64_t at = (int64_t)r * ep.E + c;
  ep.out[at] = (pick0 ? d0 : d1) * ep.e_mask[c];
  ep.choose[at] = pick0 ? 1 : 0;
}

// Shared memory: the ring; then the park, where rank 0 keeps its x0 @ w0
// sums while the same registers take x1 @ w1.  A thread's sums lie at
// [i * CONSUMERS + t] (element i of thread t), in the park and, after the
// mainloop, in the part of the ring that takes the x1 @ w1 partial sums of
// a split K.  Then the mbarriers, and slack to align the ring to the 1024
// bytes of the 128B swizzle pattern.
template <class Cfg>
__host__ __device__ constexpr int sums_bytes() {
  return Cfg::NACC * Cfg::CONSUMERS * 4;
}
template <class Cfg>
__host__ __device__ constexpr int park_offset() {
  return Cfg::STAGES * (Cfg::A_BYTES + Cfg::B_BYTES) > sums_bytes<Cfg>()
             ? Cfg::STAGES * (Cfg::A_BYTES + Cfg::B_BYTES)
             : sums_bytes<Cfg>();
}
template <class Cfg>
__host__ __device__ constexpr int smem_bytes() {
  return park_offset<Cfg>() + sums_bytes<Cfg>() + 2 * Cfg::STAGES * 8 + 1024;
}

// One kernel, two cluster roles.  Tiled (FULLE false): grid (split,
// ceil(E / BN), T * ceil(B / BM)), clusters of (split, 1, 1) that share one
// output tile's K.  Full-E (FULLE true): grid (1, ceil(E / BN), T *
// ceil(B / BM)), clusters of (1, c, 1) that span c column tiles of one row
// tile of one trial;
// every rank walks all of K in the unsplit order, loads its own w tiles,
// and each stage's x tile reaches all c ranks by one multicast.  CONSUMERS
// threads compute; the warp after them issues the TMA loads.
template <class Cfg, bool FULLE>
__global__ void __launch_bounds__(Cfg::CONSUMERS + 32, Cfg::MIN_CTAS)
embrace_fused_fwd_kernel(const __grid_constant__ CUtensorMap map_x0,
                         const __grid_constant__ CUtensorMap map_w0,
                         const __grid_constant__ CUtensorMap map_x1,
                         const __grid_constant__ CUtensorMap map_w1,
                         const Epilogue ep_all, int k0_tiles, int k1_tiles,
                         int cluster_ctas, int k_split) {
  constexpr int C = Cfg::CONSUMERS, NACC = Cfg::NACC, STAGES = Cfg::STAGES;
  constexpr int G = Cfg::GROUPS, GT = C / G;
  constexpr int STAGE_BYTES = Cfg::A_BYTES + Cfg::B_BYTES;
  constexpr int BOX_BYTES = Cfg::BOX_N * Cfg::BK * (int)sizeof(typename Cfg::T);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  float* park = reinterpret_cast<float*>(smem + park_offset<Cfg>());
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + park_offset<Cfg>() +
                                               sums_bytes<Cfg>());
  uint64_t* empty = full + STAGES;

  cg::cluster_group cluster = cg::this_cluster();
  // CTAs of the cluster.  The full-E kernel reads their count and its K
  // split (1: every rank walks all of K) from its parameters: a split
  // known at compile time lets the compiler restructure the float32
  // consumers past the 168 registers 288 threads may hold, and spill.
  const int ctas = FULLE ? cluster_ctas : (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  // the ranks that share the tile's K: the whole cluster, or (full-E) one
  const int split = FULLE ? k_split : ctas;
  const int kq = FULLE ? rank % k_split : rank;
  const int tid = threadIdx.x;
  // grid z: trial-major over the row tiles of every trial
  const int row_tiles = (ep_all.B + Cfg::BM - 1) / Cfg::BM;
  const int trial = blockIdx.z / row_tiles;
  const Epilogue ep = ep_all.trial(trial);
  const int col0 = blockIdx.y * Cfg::BN;
  const int row0 = (blockIdx.z - trial * row_tiles) * Cfg::BM;
  // The K tiles of x0 @ w0, then those of x1 @ w1, go to the ranks in
  // contiguous shares of one list: rank q takes list tiles [lo, hi), the
  // first n0 of them of x0 @ w0.
  const int lo = kq * (k0_tiles + k1_tiles) / split;
  const int hi = (kq + 1) * (k0_tiles + k1_tiles) / split;
  const int n0 = max(0, min(hi, k0_tiles) - lo);
  const int n = hi - lo;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      // full-E: a stage is refilled in every CTA at once (the x multicast),
      // so it is free once the consumer warps of all ranks released it
      mbar_init(&empty[s], C / Cfg::GROUPS / 32 * (FULLE ? ctas : 1));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (FULLE) cluster.sync();  // every rank's barriers before any multicast
  else __syncthreads();

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  if (tid >= C) {
    if (tid == C) {  // producer: one lane keeps the ring filled
      for (int t = 0; t < n; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
        uint8_t* a = smem + s * STAGE_BYTES;
        uint8_t* b = a + Cfg::A_BYTES;
        const bool first = t < n0;
        const CUtensorMap* mx = first ? &map_x0 : &map_x1;
        const CUtensorMap* mw = first ? &map_w0 : &map_w1;
        const int k = (lo + t - (first ? 0 : k0_tiles)) * Cfg::BK;
        // each CTA expects the whole x tile, whichever rank issues it:
        // full-E rank t % c, for all ranks of the cluster
        mbar_expect_tx(&full[s], STAGE_BYTES);
        if (!FULLE || ctas == 1) tma_load(a, mx, &full[s], k, row0, trial);
        else if (t % ctas == rank)
          tma_load_multicast(a, mx, &full[s], k, row0, trial,
                             (uint16_t)((1u << ctas) - 1));
#pragma unroll
        for (int h = 0; h < Cfg::BN / Cfg::BOX_N; ++h)
          tma_load(b + h * BOX_BYTES, mw, &full[s], col0 + h * Cfg::BOX_N, k,
                   trial);
      }
    }
    __syncwarp();
  } else {
    // group g takes tiles g, g + G, ...; a group without an x0 @ w0 tile
    // parks zeros
    const int g = tid / GT, gt = tid % GT;
    if (g >= n0) {
#pragma unroll
      for (int i = 0; i < NACC; ++i) park[i * C + tid] = 0.f;
    }
    for (int t = g; t < n; t += G) {
      const int s = t % STAGES;
      mbar_wait(&full[s], (t / STAGES) & 1);
      const uint8_t* a = smem + s * STAGE_BYTES;
      Cfg::mma(acc, a, a + Cfg::A_BYTES, gt);
      if (t < n0 && t + G >= n0) {  // x0 @ w0's share done: park it
        Cfg::drain(acc);
#pragma unroll
        for (int i = 0; i < NACC; ++i) {
          park[i * C + tid] = acc[i];
          acc[i] = 0.f;
        }
      }
      const int done = t - Cfg::LAG * G;  // the stage whose products are done
      if (done >= 0) {
        __syncwarp();
        if constexpr (FULLE) {  // lane q releases the stage in rank q
          if ((tid & 31) < ctas) mbar_arrive_cluster(&empty[done % STAGES], tid & 31);
        } else if ((tid & 31) == 0) {
          mbar_arrive(&empty[done % STAGES]);
        }
      }
    }
    Cfg::drain(acc);
  }
  // full-E: this CTA neither arrives on a peer's barrier nor issues a
  // multicast after here; it leaves only once every rank has got this far
  if constexpr (FULLE) cluster_arrive();

  const uint32_t key = ep.seed_dev ? (uint32_t)(*ep.seed_dev) : ep.seed;
  if (split == 1 && G == 1) {
    if (tid < C) {
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        int r, c;
        Cfg::coords(i, tid, r, c);
        finish(ep, key, row0 + r, col0 + c, park[i * C + tid], acc[i]);
      }
    }
  } else {
    // Split K (across the cluster's ranks, the CTA's groups, or both): the
    // x1 @ w1 partial sums go to the start of the ring, free once every CTA
    // of the cluster has passed the first barrier.  Rank q then finishes
    // elements [q * NACC / split, (q + 1) * NACC / split) of every group
    // thread, group g of the rank taking every G-th of them, adding the
    // partial sums in (rank, group) order: x1 @ w1's from every rank, x0 @
    // w0's from the parks of the ranks that took x0 tiles.  Full-E: only
    // the CTA's own groups, in its own shared memory.
    float* part = reinterpret_cast<float*>(smem);
    auto sync_sums = [&] {
      if constexpr (FULLE) __syncthreads();
      else cluster.sync();
    };
    sync_sums();
    if (tid < C) {
#pragma unroll
      for (int i = 0; i < NACC; ++i) part[i * C + tid] = acc[i];
    }
    sync_sums();
    if (tid < C) {
      const int g = tid / GT, gt = tid % GT;
      for (int i = kq * NACC / split + g; i < (kq + 1) * NACC / split; i += G) {
        float a0 = 0.f, a1 = 0.f;
        for (int q = 0; q < split; ++q) {
          const bool x0_share = q * (k0_tiles + k1_tiles) / split < k0_tiles;
          const float* pk = FULLE ? park : cluster.map_shared_rank(park, q);
          const float* pt = FULLE ? part : cluster.map_shared_rank(part, q);
          for (int h = 0; h < G; ++h) {
            if (x0_share) a0 += pk[i * C + h * GT + gt];
            a1 += pt[i * C + h * GT + gt];
          }
        }
        int r, c;
        Cfg::coords(i, gt, r, c);
        finish(ep, key, row0 + r, col0 + c, a0, a1);
      }
    }
    if constexpr (!FULLE) cluster.sync();  // no CTA leaves while another reads its shared memory
  }
  if constexpr (FULLE) cluster_wait();
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: it is
// looked up through the runtime's entry-point query, so the library needs
// no link against libcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// T matrices of [rows, cols], row stride ld and trial stride ldt
// (elements), read in boxes of box_rows x box_cols of one trial;
// out-of-bounds elements read as zero
bool make_map(CUtensorMap* map, const void* base, CUtensorMapDataType dt,
              int item, int T, long long rows, long long cols, long long ld,
              long long ldt, int box_cols, int box_rows,
              CUtensorMapSwizzle swizzle) {
  // a stride that is never used (one row, one trial) must still be a
  // multiple of 16 bytes
  const cuuint64_t stride =
      rows > 1 ? (cuuint64_t)ld * item : (((cuuint64_t)cols * item + 15) / 16) * 16;
  const cuuint64_t tstride = T > 1 ? (cuuint64_t)ldt * item
                                   : stride * (cuuint64_t)(rows > 1 ? rows : 1);
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)T};
  const cuuint64_t strides[2] = {stride, tstride};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encoder()(map, dt, 3, const_cast<void*>(base), dims, strides, box,
                   elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The launch configuration of one plan: grid, block, shared memory, cluster
// dims (`cluster` CTAs: along K for the tiled kernel, along E for the
// full-E kernel).  Also lifts the kernel's shared-memory limit, once per
// device.
template <class Cfg, bool FULLE>
cudaError_t launch_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                          int T, int B, int E, int cluster, cudaStream_t stream) {
  constexpr int smem = smem_bytes<Cfg>();
  static unsigned long long lifted = 0;  // one bit per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (!(lifted >> device & 1)) {
    err = cudaFuncSetAttribute(embrace_fused_fwd_kernel<Cfg, FULLE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    lifted |= 1ull << device;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(FULLE ? 1 : cluster, (E + Cfg::BN - 1) / Cfg::BN,
                      T * ((B + Cfg::BM - 1) / Cfg::BM));
  cfg->blockDim = dim3(Cfg::CONSUMERS + 32);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = FULLE ? 1 : cluster;
  attr[0].val.clusterDim.y = FULLE ? cluster : 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <class Cfg, bool FULLE>
int launch(const void* x0, long long ld_x0, long long lt_x0, const void* x1,
           long long ld_x1, long long lt_x1, const void* w0, long long ld_w0,
           long long lt_w0, const void* w1, long long ld_w1, long long lt_w1,
           const Epilogue& ep, int T, int D0, int D1, int cluster,
           cudaStream_t stream) {
  constexpr int item = (int)sizeof(typename Cfg::T);
  // a full-E cluster spans whole column tiles: c divides them
  if (FULLE && ((ep.E + Cfg::BN - 1) / Cfg::BN) % cluster != 0)
    return (int)cudaErrorInvalidValue;
  if (!encoder()) return (int)cudaErrorNotSupported;
  CUtensorMap mx0, mw0, mx1, mw1;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!make_map(&mx0, x0, Cfg::DT, item, T, ep.B, D0, ld_x0, lt_x0, Cfg::BK,
                Cfg::BM, sw) ||
      !make_map(&mx1, x1, Cfg::DT, item, T, ep.B, D1, ld_x1, lt_x1, Cfg::BK,
                Cfg::BM, sw) ||
      !make_map(&mw0, w0, Cfg::DT, item, T, D0, ep.E, ld_w0, lt_w0, Cfg::BOX_N,
                Cfg::BK, Cfg::W_SWIZZLE) ||
      !make_map(&mw1, w1, Cfg::DT, item, T, D1, ep.E, ld_w1, lt_w1, Cfg::BOX_N,
                Cfg::BK, Cfg::W_SWIZZLE))
    return (int)cudaErrorInvalidValue;

  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const cudaError_t err =
      launch_config<Cfg, FULLE>(&cfg, attr, T, ep.B, ep.E, cluster, stream);
  if (err != cudaSuccess) return (int)err;
  const int k0_tiles = (D0 + Cfg::BK - 1) / Cfg::BK;
  const int k1_tiles = (D1 + Cfg::BK - 1) / Cfg::BK;
  return (int)cudaLaunchKernelEx(&cfg, embrace_fused_fwd_kernel<Cfg, FULLE>, mx0,
                                 mw0, mx1, mw1, ep, k0_tiles, k1_tiles, cluster,
                                 FULLE ? 1 : cluster);
}

// f(Cfg{}) for the tile configuration of operand type `dtype` (0 = float32,
// 1 = bf16) and `bm` rows, or `bad` where there is none
template <class F>
int with_tiles(int dtype, int bm, int bad, F f) {
  if (dtype == 1 && bm == 64) return f(Bf16Tiles<1>{});
  if (dtype == 1 && bm == 128) return f(Bf16Tiles<2>{});
  if (dtype == 0 && bm == 64) return f(F32Tiles<128, 2>{});
  if (dtype == 0 && bm == 128) return f(F32Tiles<256>{});
  return bad;
}

template <bool FULLE>
int entry(int dtype, const void* x0, long long ld_x0, long long lt_x0,
          const void* x1, long long ld_x1, long long lt_x1, const void* w0,
          long long ld_w0, long long lt_w0, const void* w1, long long ld_w1,
          long long lt_w1, const Epilogue& ep, int T, int D0, int D1,
          void* stream, int bm, int cluster) {
  if (T <= 0 || ep.B <= 0 || ep.E <= 0) return (int)cudaSuccess;
  if (D0 <= 0 || D1 <= 0 || cluster < 1 || cluster > 8 ||
      (long long)T * ((ep.B + bm - 1) / bm) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_tiles(dtype, bm, (int)cudaErrorInvalidValue, [&](auto tiles) {
    return launch<decltype(tiles), FULLE>(x0, ld_x0, lt_x0, x1, ld_x1, lt_x1,
                                          w0, ld_w0, lt_w0, w1, ld_w1, lt_w1,
                                          ep, T, D0, D1, cluster, s);
  });
}

}  // namespace

// The two launch entries, embrace_fused_fwd (tiled) and
// embrace_fused_fwd_fulle (full-E): dtype 0 = float32 operands, 1 =
// bfloat16 operands.  T trials: x0 [T, B, D0], x1 [T, B, D1], w0 [T, D0,
// E], w1 [T, D1, E] with row strides ld_* and trial strides lt_*
// (elements; unused for T = 1); b0, b1, e_mask [T, E], p0 [T, B], out and
// choose [T, B, E] contiguous.  seed_dev: null (every trial keyed by
// `seed`), or a device pointer to T int64 keys whose low 32 bits key trial
// t.  row_base: added to every row's draw counter, so a launch on rows [r,
// r + B) of a batch with row_base = r draws what the whole batch's launch
// draws for those rows (0: the batch).  Return the CUDA error code of the
// launch (0 = success); a bad argument returns cudaErrorInvalidValue.  They
// launch on `stream` and do not synchronise.  Every operand's base must be
// 16-byte aligned and every row and trial stride (times the element size)
// a multiple of 16 bytes where it has more than one row or trial: TMA reads
// them.
//
// Both take a launch plan: bm, the rows of an output tile (64 or 128), and
// a cluster width of 1 to 8.  embrace_fused_fwd: `split` of ops/embrace.py::
// launch_plan, the CTAs of a cluster that share one tile's K.
// embrace_fused_fwd_fulle: `cluster` of ops/embrace.py::fulle_plan, the
// column tiles (128 features each) a cluster spans; it divides their number.
extern "C" int embrace_fused_fwd(int dtype, const void* x0, long long ld_x0,
                                 long long lt_x0, const void* x1,
                                 long long ld_x1, long long lt_x1,
                                 const void* w0, long long ld_w0,
                                 long long lt_w0, const void* w1,
                                 long long ld_w1, long long lt_w1,
                                 const float* b0, const float* b1,
                                 const float* p0, const float* e_mask,
                                 float* out, uint8_t* choose, int T, int B,
                                 int D0, int D1, int E, unsigned int seed,
                                 const long long* seed_dev, int row_base,
                                 void* stream, int bm, int split) {
  const Epilogue ep{b0, b1, p0, e_mask, out, choose, B, E, seed, seed_dev,
                    row_base};
  return entry<false>(dtype, x0, ld_x0, lt_x0, x1, ld_x1, lt_x1, w0, ld_w0,
                      lt_w0, w1, ld_w1, lt_w1, ep, T, D0, D1, stream, bm, split);
}

extern "C" int embrace_fused_fwd_fulle(int dtype, const void* x0,
                                       long long ld_x0, long long lt_x0,
                                       const void* x1, long long ld_x1,
                                       long long lt_x1, const void* w0,
                                       long long ld_w0, long long lt_w0,
                                       const void* w1, long long ld_w1,
                                       long long lt_w1, const float* b0,
                                       const float* b1, const float* p0,
                                       const float* e_mask, float* out,
                                       uint8_t* choose, int T, int B, int D0,
                                       int D1, int E, unsigned int seed,
                                       const long long* seed_dev, int row_base,
                                       void* stream, int bm, int cluster) {
  const Epilogue ep{b0, b1, p0, e_mask, out, choose, B, E, seed, seed_dev,
                    row_base};
  return entry<true>(dtype, x0, ld_x0, lt_x0, x1, ld_x1, lt_x1, w0, ld_w0,
                     lt_w0, w1, ld_w1, lt_w1, ep, T, D0, D1, stream, bm,
                     cluster);
}

// How many clusters of `cluster` CTAs of one plan fit on the card at once
// (cudaOccupancyMaxActiveClusters) for the tiled kernel (fulle 0) or the
// full-E kernel (fulle 1), or -1 on an error: fewer than ctas / cluster
// means the grid runs in more than one wave.  B and E must give a grid that
// the cluster divides.
extern "C" int embrace_fused_fwd_clusters(int fulle, int dtype, int B, int E,
                                          int bm, int cluster) {
  return with_tiles(dtype, bm, -1, [&](auto tiles) {
    using Cfg = decltype(tiles);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    int clusters = -1;
    const cudaError_t err =
        fulle ? launch_config<Cfg, true>(&cfg, attr, 1, B, E, cluster, 0)
              : launch_config<Cfg, false>(&cfg, attr, 1, B, E, cluster, 0);
    if (err != cudaSuccess) return -1;
    const cudaError_t q =
        fulle ? cudaOccupancyMaxActiveClusters(
                    &clusters, embrace_fused_fwd_kernel<Cfg, true>, &cfg)
              : cudaOccupancyMaxActiveClusters(
                    &clusters, embrace_fused_fwd_kernel<Cfg, false>, &cfg);
    return q == cudaSuccess ? clusters : -1;
  });
}
