// Flash attention, forward and backward, written by hand for Hopper
// (sm_90a), with a plain C interface that the Python side binds with ctypes
// (pytorch_distributed_training_tpu_torch/kernels/__init__.py).
//
// q, k, v, o, dO, dq, dk, dv are [BH, S, D] (heads folded into the batch),
// lse and delta are [BH, S] f32. D is 64 or 128; S is a multiple of 128 in
// bf16 (the tiles of the TMA kernels) and of 64 in f32.
//
// The forward (pdt_flash_fwd: flash_fwd_bf16_kernel, flash_fwd_f32_kernel)
// stands in for both TPU forwards, `_fwd_kernel`
// (pytorch_distributed_training_tpu/ops/flash_attention.py:178, launched at
// :651), which holds the whole K/V rows in VMEM, and `_fwd_stream_kernel`
// (:407, launched at :615), which streams K/V tiles once 2 S D 4 bytes pass
// the 8 MiB VMEM budget (:114-120). Here K/V always stream through shared
// memory one tile at a time, so one kernel covers every S: online
// softmax with f32 accumulation, o in the input dtype and lse = m + log(l)
// (natural log) in f32. With `causal` the loop over K tiles stops at the
// diagonal tile (:190-194); masked scores are -1e30, not -inf (:48-50, :68),
// applied only on the tiles the diagonal crosses.
//
// The backward is two launches, each deterministic: a dK/dV kernel
// (pdt_flash_bwd_dkv: flash_bwd_dkv_bf16_kernel, _f32_kernel) that owns a K
// tile and loops over Q tiles, and a dQ kernel (pdt_flash_bwd_dq:
// flash_bwd_dq_bf16_kernel, _f32_kernel) that owns a Q tile and loops over K
// tiles. That is the TPU's split backward, `_dkv_kernel` (:348) /
// `_dq_kernel` (:233) for resident shapes and `_dkv_stream_kernel` (:506) /
// `_dq_stream_kernel` (:460) for streamed ones; the pair also stands in for
// the fused `_dqkv_kernel` (:278, launched at :775), which carries dK/dV in
// VMEM across a sequential grid dimension (:296-300, "arbitrary" at :781):
// blocks on this card run in no order. Both recompute p = exp(s - lse);
// delta = rowsum(dO * O) comes from outside, as in the JAX package
// (:761-764). dK/dV accumulate in f32 and are rounded once when written
// (:802); dq is written in q's dtype.
//
// Numerics, as in the JAX kernels:
// - bf16 inputs: bf16 operands into the tensor cores with f32 accumulation;
//   the scale multiplies s after the dot, in f32 (:206-207); p is rounded to
//   bf16 before PV and before dV (:216, :327); ds is rounded to bf16 before
//   dK and dQ (:335).
// - f32 inputs: f32 FMA on the CUDA cores, no TF32; q * scale before the dot
//   in the forward (:188), scale * (q . k) in the backward (:256, :319).
//
// Bound: operations (`flash_flops` in ops/flash_attention.py: 2 S D
// multiply-adds x 2 per kept (query, key) pair and product; the forward has
// 2 products, dK/dV 4, dQ 3). At the LM's shape (BH 128, S 2048, D 64,
// causal) the forward is 68.7 GFLOP (0.069 ms at 989 TFLOP/s bf16) against
// 135 MB of traffic (0.04 ms at 3.35 TB/s); dK/dV is 137.4 GFLOP, dQ 103.1
// GFLOP (0.104 ms) against 170 MB (0.05 ms). In f32 the same work runs at
// most at 67 TFLOP/s.
//
// bf16 forward, dK/dV and dQ, designed for Hopper. 384 threads: warpgroup 0
// produces (one thread issues every copy; setmaxnreg hands its registers
// to the others), warpgroups 1 and 2 consume, 64 rows each (wgmma's M).
// Tiles arrive by TMA (cp.async.bulk.tensor over a 2D map of the [BH S, D]
// view, encoded per call with cuTensorMapEncodeTiled and passed as a
// __grid_constant__ parameter) with the 128-byte swizzle, in boxes of 64
// columns (128 bytes): a D = 128 tile is two slabs. Each stage of a ring
// has a full mbarrier, which the copies complete by their byte count, and
// an empty one, on which the 8 consumer warps arrive once their wgmma have
// read the stage. Every product is wgmma.mma_async with f32 accumulators
// in registers. A product that contracts over D takes both operands from
// shared memory, K-major (the descriptor advances 32 bytes per k16 step
// inside the swizzled row); a product that contracts over a tile's rows
// takes A (bf16 p or ds) from registers, packed from the accumulator of the
// product before (the m64nN accumulator layout is the m64k16 A-fragment
// layout), and B MN-major from the one staged copy of V, dO or Q: the
// descriptor's major-ness replaces a transposed copy in shared memory.
// - Forward: a block owns a 128-row Q tile (loaded once) and streams
//   128-row K and V tiles through a 2-stage ring, with separate full
//   barriers for K and V so that S = Q K^T starts before V lands.
//   Softmax stays in registers: row max and row sum over the 4 lanes that
//   hold a row, p = exp2f(one FFMA of the scaled score). Blocks take the
//   longest rows first (grid y counts Q tiles from the last).
// - dK/dV: a block owns a 128-row K/V tile (loaded once) and streams 64-row
//   Q and dO tiles, with their lse and delta rows (cp.async.bulk), through
//   a 2-stage ring. Per Q tile, every product transposed (rows = keys):
//   S^T = K Q^T and dP^T = V dO^T (SS, both in flight), P^T = exp(scale S^T
//   - lse), dV += bf16(P^T) dO (RS), dS^T = P^T (dP^T - delta) scale,
//   dK += bf16(dS^T) Q (RS). Causal: the first Q tile of K tile kt is 2 kt,
//   and the two Q tiles 2 kt and 2 kt + 1 cross the diagonal; blocks of the
//   low K tiles, which see the most Q tiles, go first.
// - dQ: the forward's shape. A block owns a 128-row Q tile and its dO tile
//   (loaded once; each consumer thread reads its two rows' lse and delta
//   once) and streams 64-row K and V tiles through a 3-stage ring. Per K
//   tile: S = Q K^T and dP = dO V^T (SS, both in flight), P = exp(scale S
//   - lse) (no online softmax: lse is given), dS = P (dP - delta) scale,
//   dQ += bf16(dS) K (RS, K read MN-major from its one staged copy: no
//   transposed copy). 64 keys a tile keep a consumer's live state at s 32
//   + dp 32 + dq D/2 + 16 fragment registers. Each tile waits for its own
//   dQ product: leaving it in flight behind the next tile's S and dP ran
//   8-21% slower on the H100, ptxas serialising the D = 128 wgmma (C7512). Causal: Q tile qt visits K
//   tiles 0 .. 2 qt + 1; tile 2 qt is the diagonal of the first consumer
//   warpgroup and 2 qt + 1 that of the second. The first skips the math of
//   tile 2 qt + 1 (all masked for its rows) but still waits on it and frees
//   its stage. Blocks take the longest rows first. dq is rounded once and written by the block that
//   owns its rows: no atomics, so it repeats bit for bit.
// f32 design: see the f32 section.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum DType : int { kF32 = 0, kBF16 = 1 };

typedef __nv_bfloat16 bf16;

constexpr float kNeg = -1e30f;  // finite mask value (flash_attention.py:68)
constexpr int kTile = 64;       // f32 kernels: query rows / key rows per tile

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// bf16 forward, dK/dV and dQ: TMA, mbarriers and wgmma (design in the header)

constexpr int kRows = 128;       // forward Q/K/V tiles, dK/dV K/V tiles, dQ Q/dO tiles
constexpr int kQRows = 64;       // dK/dV Q/dO tiles
constexpr int kKRows = 64;       // dQ K/V tiles
constexpr int kStages = 2;       // depth of the forward's and dK/dV's rings
constexpr int kDqStages = 3;     // depth of dQ's ring
constexpr int kWarpgroup = 128;
constexpr int kHopperThreads = 3 * kWarpgroup;  // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
// setmaxnreg: 128 x 24 + 256 x 240 <= 65536. The exact fit, 32 and 240,
// hung on the H100: the consumers' setmaxnreg.inc never returned
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kSwizzleRow = 128;   // bytes in a swizzled row: 64 bf16
// dynamic shared memory of a TMA kernel is at least this: more than half an
// SM's 228 KB, so one block holds an SM and setmaxnreg.inc always finds the
// registers that its producer gave up (a second block could hold them)
constexpr int kOneBlockSmem = 116 * 1024;
constexpr uint32_t kSpinLimit = 1u << 26;  // polls of a barrier before a trap
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spin until the phase of parity `parity` has completed; a wait that
// never ends (a copy that never lands) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (++polls == kSpinLimit) __trap();
  } while (!done);
}

// the box of a 2D tensor map at (column c0, row c1) into shared memory at
// dst; the copy completes its bytes on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` (a multiple of 16) contiguous bytes from global memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma descriptor of an operand in shared memory with the 128-byte swizzle
// (layout type 1, bits 62-63): start address, leading and stride byte
// offsets, each in 16-byte units. K-major: the stride offset steps 8 rows
// (1024 bytes), the leading one is unused. MN-major: the stride offset
// steps 8 rows along K, the leading one to the next 64 columns (slab).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving an access to these registers across a
// wgmma issue or wait (the tensor cores read and write them asynchronously)
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int M, int N>
__device__ __forceinline__ void pin(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// d (m64n64, f32) = a * b (+ d unless scale_d is 0): a and b in shared
// memory, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (m64n128, f32) = a * b (+ d unless scale_d is 0): a and b in shared
// memory, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (m64n64, f32) += a * b: a (a bf16 m64k16 fragment) from registers, b in
// shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64n128, f32) += a * b: a (a bf16 m64k16 fragment) from registers, b in
// shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64nD) += a * b for a head dim of D, b MN-major
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 64) {
    wgmma_rs_n64(d, a, b);
  } else {
    wgmma_rs_n128(d, a, b);
  }
}

// the bf16 A fragment of k16 step kk (columns 16 kk .. 16 kk + 15) of an
// m64nN accumulator
template <int N>
__device__ __forceinline__ void acc_to_frag(uint32_t (&a)[4], const float (&acc)[N], int kk) {
  a[0] = pack_bf16(acc[8 * kk], acc[8 * kk + 1]);
  a[1] = pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);
  a[2] = pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);
  a[3] = pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);
}

__device__ __forceinline__ void init_barriers(uint32_t first, int n_full, uint32_t empty,
                                              int stages = kStages) {
  for (int i = 0; i < n_full; ++i) mbar_init(first + 8 * i, 1);
  for (int s = 0; s < stages; ++s) mbar_init(empty + 8 * s, kConsumerWarps);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// forward shared memory: byte offsets from a 1024-byte aligned base (the
// swizzle pattern repeats every 8 rows of 128 bytes)
template <int D>
struct FwdLayout {
  static constexpr int kSlabBytes = kRows * kSwizzleRow;  // 128 rows x 64 columns
  static constexpr int kTileBytes = (D / 64) * kSlabBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTileBytes;               // kStages tiles
  static constexpr int kV = kK + kStages * kTileBytes;     // kStages tiles
  static constexpr int kBars = kV + kStages * kTileBytes;  // q_full, k_full[], v_full[], empty[]
  static constexpr int kUsed = kBars + 8 * (1 + 3 * kStages) + 1024;  // + room to align
  static constexpr int kBytes = kUsed > kOneBlockSmem ? kUsed : kOneBlockSmem;
};

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
                      float* __restrict__ lse, int seq, float scale, int causal) {
  using L = FwdLayout<D>;
  extern __shared__ __align__(128) unsigned char tma_smem[];
  const uint32_t base = (smem_addr(tma_smem) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBars;
  const uint32_t k_full = q_full + 8;  // stage s: + 8 s
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;
  const int n_tiles = seq / kRows;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.y);  // longest rows first
  const int n_kv = causal ? qt + 1 : n_tiles;
  const int row0 = static_cast<int>(blockIdx.x) * seq;  // the head's first row of [BH S, D]
  if (threadIdx.x == 0) init_barriers(q_full, 1 + 2 * kStages, empty);
  __syncthreads();

  if (threadIdx.x < kWarpgroup) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kTileBytes);
      for (int c = 0; c < D / 64; ++c) {
        tma_load(base + L::kQ + c * L::kSlabBytes, &q_map, q_full, c * 64, row0 + qt * kRows);
      }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty + 8 * s, ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(k_full + 8 * s, L::kTileBytes);
        for (int c = 0; c < D / 64; ++c) {
          tma_load(base + L::kK + s * L::kTileBytes + c * L::kSlabBytes, &k_map, k_full + 8 * s,
                   c * 64, row0 + j * kRows);
        }
        mbar_expect_tx(v_full + 8 * s, L::kTileBytes);
        for (int c = 0; c < D / 64; ++c) {
          tma_load(base + L::kV + s * L::kTileBytes + c * L::kSlabBytes, &v_map, v_full + 8 * s,
                   c * 64, row0 + j * kRows);
        }
      }
    }
  } else {  // consumers: warpgroup 1 takes rows 0..63 of the Q tile, 2 rows 64..127
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int half = threadIdx.x / kWarpgroup - 1;
    const int warp = (threadIdx.x % kWarpgroup) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = half * 64 + warp * 16 + g;  // this thread's rows r0, r0 + 8 of the tile
    const uint32_t q_rows = base + L::kQ + half * 64 * kSwizzleRow;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
    mbar_wait(q_full, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      const uint32_t k_tile = base + L::kK + s * L::kTileBytes;
      const uint32_t v_tile = base + L::kV + s * L::kTileBytes;
      // s = Q K^T: [64 rows, 128 keys], k16 steps along D
      float sc[64];
      mbar_wait(k_full + 8 * s, parity);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * L::kSlabBytes + (kk % 4) * 32;
        wgmma_ss_n128(sc, desc(q_rows + off, 16, 1024), desc(k_tile + off, 16, 1024), kk);
      }
      wg_commit();
      wg_wait<0>();
      pin(sc);
      // online softmax; the mask only on the diagonal tile
      const bool diag = causal && j == qt;
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float val = sc[4 * n + e] * scale;
          if (diag && n * 8 + 2 * t + (e & 1) > r0 + (e >= 2 ? 8 : 0)) val = kNeg;
          sc[4 * n + e] = val;
          if (e < 2) {
            mx0 = fmaxf(mx0, val);
          } else {
            mx1 = fmaxf(mx1, val);
          }
        }
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float a0 = exp2f((m0 - mx0) * kLog2e), a1 = exp2f((m1 - mx1) * kLog2e);
      const float b0 = mx0 * kLog2e, b1 = mx1 * kLog2e;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        sc[4 * n] = exp2f(fmaf(sc[4 * n], kLog2e, -b0));
        sc[4 * n + 1] = exp2f(fmaf(sc[4 * n + 1], kLog2e, -b0));
        sc[4 * n + 2] = exp2f(fmaf(sc[4 * n + 2], kLog2e, -b1));
        sc[4 * n + 3] = exp2f(fmaf(sc[4 * n + 3], kLog2e, -b1));
        ps0 += sc[4 * n] + sc[4 * n + 1];
        ps1 += sc[4 * n + 2] + sc[4 * n + 3];
      }
      l0 = a0 * l0 + quad_sum(ps0);
      l1 = a1 * l1 + quad_sum(ps1);
      m0 = mx0;
      m1 = mx1;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[4 * n] *= a0;
        acc[4 * n + 1] *= a0;
        acc[4 * n + 2] *= a1;
        acc[4 * n + 3] *= a1;
      }
      // o += bf16(p) V: 8 k16 steps over the tile's keys, V read MN-major
      uint32_t pa[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) acc_to_frag(pa[kk], sc, kk);
      mbar_wait(v_full + 8 * s, parity);
      pin(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_rs<D>(acc, pa[kk], desc(v_tile + kk * 16 * kSwizzleRow, L::kSlabBytes, 1024));
      }
      wg_commit();
      wg_wait<0>();
      pin(acc);
      pin(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    const int row = qt * kRows + r0;
    bf16* o0 = o + (static_cast<size_t>(row0) + row) * D;
    bf16* o1 = o0 + 8 * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(o0 + col) = pack_bf16(acc[4 * n] / l0, acc[4 * n + 1] / l0);
      *reinterpret_cast<uint32_t*>(o1 + col) = pack_bf16(acc[4 * n + 2] / l1, acc[4 * n + 3] / l1);
    }
    if (t == 0) {
      float* lr = lse + row0 + row;
      lr[0] = m0 + logf(l0);
      lr[8] = m1 + logf(l1);
    }
  }
}

// dK/dV shared memory, as FwdLayout
template <int D>
struct DkvLayout {
  static constexpr int kKvSlabBytes = kRows * kSwizzleRow;  // 128 key rows x 64 columns
  static constexpr int kKvBytes = (D / 64) * kKvSlabBytes;
  static constexpr int kQSlabBytes = kQRows * kSwizzleRow;  // 64 query rows x 64 columns
  static constexpr int kQBytes = (D / 64) * kQSlabBytes;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKvBytes;
  static constexpr int kQ = kV + kKvBytes;                      // kStages tiles
  static constexpr int kDo = kQ + kStages * kQBytes;            // kStages tiles
  static constexpr int kLse = kDo + kStages * kQBytes;          // kStages x kQRows f32
  static constexpr int kDelta = kLse + kStages * kQRows * 4;    // kStages x kQRows f32
  static constexpr int kBars = kDelta + kStages * kQRows * 4;   // kv_full, full[], empty[]
  static constexpr int kStageTx = 2 * kQBytes + 2 * kQRows * 4;  // bytes of one stage's copies
  static constexpr int kUsed = kBars + 8 * (1 + 2 * kStages) + 1024;  // + room to align
  static constexpr int kBytes = kUsed > kOneBlockSmem ? kUsed : kOneBlockSmem;
};

// dK/dV: the block owns K/V tile kt (128 keys; consumer warpgroup 1 keys
// 0..63, 2 keys 64..127) and streams 64-row Q tiles; every product is
// computed transposed (rows = keys)
template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int seq, float scale,
                          int causal) {
  using L = DkvLayout<D>;
  extern __shared__ __align__(128) unsigned char tma_smem[];
  const uint32_t base = (smem_addr(tma_smem) + 1023u) & ~1023u;
  const unsigned char* smem = tma_smem + (base - smem_addr(tma_smem));  // generic pointer to base
  const uint32_t kv_full = base + L::kBars;
  const uint32_t full = kv_full + 8;  // stage s: + 8 s
  const uint32_t empty = full + 8 * kStages;
  const int kt = blockIdx.y;  // causal: low K tiles see the most Q tiles and go first
  const int row0 = static_cast<int>(blockIdx.x) * seq;
  const int q_first = causal ? kt * (kRows / kQRows) : 0;
  const int n_q = seq / kQRows;
  if (threadIdx.x == 0) init_barriers(kv_full, 1 + kStages, empty);
  __syncthreads();

  if (threadIdx.x < kWarpgroup) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * L::kKvBytes);
      for (int c = 0; c < D / 64; ++c) {
        tma_load(base + L::kK + c * L::kKvSlabBytes, &k_map, kv_full, c * 64, row0 + kt * kRows);
        tma_load(base + L::kV + c * L::kKvSlabBytes, &v_map, kv_full, c * 64, row0 + kt * kRows);
      }
      for (int i = 0, qi = q_first; qi < n_q; ++i, ++qi) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty + 8 * s, ((i / kStages) & 1) ^ 1);
        const uint32_t bar = full + 8 * s;
        const int row = row0 + qi * kQRows;
        mbar_expect_tx(bar, L::kStageTx);
        for (int c = 0; c < D / 64; ++c) {
          tma_load(base + L::kQ + s * L::kQBytes + c * L::kQSlabBytes, &q_map, bar, c * 64, row);
          tma_load(base + L::kDo + s * L::kQBytes + c * L::kQSlabBytes, &do_map, bar, c * 64, row);
        }
        bulk_load(base + L::kLse + s * kQRows * 4, lse + row, kQRows * 4, bar);
        bulk_load(base + L::kDelta + s * kQRows * 4, delta + row, kQRows * 4, bar);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int half = threadIdx.x / kWarpgroup - 1;
    const int warp = (threadIdx.x % kWarpgroup) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int key0 = kt * kRows + half * 64 + warp * 16 + g;  // this thread's keys key0, key0 + 8
    const uint32_t k_rows = base + L::kK + half * 64 * kSwizzleRow;
    const uint32_t v_rows = base + L::kV + half * 64 * kSwizzleRow;
    const float scale2 = scale * kLog2e;
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(kv_full, 0);
    for (int i = 0, qi = q_first; qi < n_q; ++i, ++qi) {
      const int s = i % kStages;
      const uint32_t q_tile = base + L::kQ + s * L::kQBytes;
      const uint32_t do_tile = base + L::kDo + s * L::kQBytes;
      const float* lse_s = reinterpret_cast<const float*>(smem + L::kLse + s * kQRows * 4);
      const float* delta_s = reinterpret_cast<const float*>(smem + L::kDelta + s * kQRows * 4);
      // s^T = K Q^T and dp^T = V dO^T: [64 keys, 64 queries] each, two groups
      float st[32], dpt[32];
      mbar_wait(full + 8 * s, (i / kStages) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss_n64(st, desc(k_rows + (kk / 4) * L::kKvSlabBytes + (kk % 4) * 32, 16, 1024),
                     desc(q_tile + (kk / 4) * L::kQSlabBytes + (kk % 4) * 32, 16, 1024), kk);
      }
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss_n64(dpt, desc(v_rows + (kk / 4) * L::kKvSlabBytes + (kk % 4) * 32, 16, 1024),
                     desc(do_tile + (kk / 4) * L::kQSlabBytes + (kk % 4) * 32, 16, 1024), kk);
      }
      wg_commit();
      wg_wait<1>();
      pin(st);
      // p^T = exp(scale s^T - lse), 0 above the diagonal: Q tiles 2 kt and
      // 2 kt + 1 cross it
      const bool diag = causal && qi / (kRows / kQRows) == kt;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 lq = *reinterpret_cast<const float2*>(lse_s + n * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = qi * kQRows + n * 8 + 2 * t + (e & 1);
          const float l = (e & 1) ? lq.y : lq.x;
          st[4 * n + e] = (diag && q < key0 + (e >= 2 ? 8 : 0))
                              ? 0.f
                              : exp2f(fmaf(st[4 * n + e], scale2, -l * kLog2e));
        }
      }
      // dV += bf16(p^T) dO: 4 k16 steps over the queries, dO read MN-major
      uint32_t fr[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_frag(fr[kk], st, kk);
      pin(dv_acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<D>(dv_acc, fr[kk], desc(do_tile + kk * 16 * kSwizzleRow, L::kQSlabBytes, 1024));
      }
      wg_commit();
      wg_wait<1>();  // dp^T has landed; dV may still run
      pin(dpt);
      // ds^T = p^T (dp^T - delta) scale
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 dl = *reinterpret_cast<const float2*>(delta_s + n * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[4 * n + e] = st[4 * n + e] * (dpt[4 * n + e] - ((e & 1) ? dl.y : dl.x)) * scale;
        }
      }
      wg_wait<0>();
      pin(dv_acc);
      pin(fr);
      // dK += bf16(ds^T) Q, Q read MN-major
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_frag(fr[kk], st, kk);
      pin(dk_acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<D>(dk_acc, fr[kk], desc(q_tile + kk * 16 * kSwizzleRow, L::kQSlabBytes, 1024));
      }
      wg_commit();
      wg_wait<0>();
      pin(dk_acc);
      pin(fr);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    const size_t r = (static_cast<size_t>(row0) + key0) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const size_t col = r + n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dk + col) = pack_bf16(dk_acc[4 * n], dk_acc[4 * n + 1]);
      *reinterpret_cast<uint32_t*>(dk + col + 8 * D) = pack_bf16(dk_acc[4 * n + 2], dk_acc[4 * n + 3]);
      *reinterpret_cast<uint32_t*>(dv + col) = pack_bf16(dv_acc[4 * n], dv_acc[4 * n + 1]);
      *reinterpret_cast<uint32_t*>(dv + col + 8 * D) = pack_bf16(dv_acc[4 * n + 2], dv_acc[4 * n + 3]);
    }
  }
}

// dQ shared memory, as FwdLayout
template <int D>
struct DqLayout {
  static constexpr int kQSlabBytes = kRows * kSwizzleRow;    // 128 query rows x 64 columns
  static constexpr int kQBytes = (D / 64) * kQSlabBytes;
  static constexpr int kKvSlabBytes = kKRows * kSwizzleRow;  // 64 key rows x 64 columns
  static constexpr int kKvBytes = (D / 64) * kKvSlabBytes;
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + kQBytes;
  static constexpr int kK = kDo + kQBytes;                    // kDqStages tiles
  static constexpr int kV = kK + kDqStages * kKvBytes;        // kDqStages tiles
  static constexpr int kBars = kV + kDqStages * kKvBytes;     // qdo_full, full[], empty[]
  static constexpr int kUsed = kBars + 8 * (1 + 2 * kDqStages) + 1024;  // + room to align
  static constexpr int kBytes = kUsed > kOneBlockSmem ? kUsed : kOneBlockSmem;
};

// dQ: the block owns Q tile qt (128 rows; consumer warpgroup 1 rows 0..63,
// 2 rows 64..127) and streams 64-row K and V tiles
template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, int seq, float scale, int causal) {
  using L = DqLayout<D>;
  extern __shared__ __align__(128) unsigned char tma_smem[];
  const uint32_t base = (smem_addr(tma_smem) + 1023u) & ~1023u;
  const uint32_t qdo_full = base + L::kBars;
  const uint32_t full = qdo_full + 8;  // stage s: + 8 s
  const uint32_t empty = full + 8 * kDqStages;
  const int n_tiles = seq / kRows;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.y);  // longest rows first
  // causal: K tiles 2 qt and 2 qt + 1 cross the diagonal
  const int n_kv = causal ? 2 * qt + 2 : seq / kKRows;
  const int row0 = static_cast<int>(blockIdx.x) * seq;  // the head's first row of [BH S, D]
  if (threadIdx.x == 0) init_barriers(qdo_full, 1 + kDqStages, empty, kDqStages);
  __syncthreads();

  if (threadIdx.x < kWarpgroup) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(qdo_full, 2 * L::kQBytes);
      for (int c = 0; c < D / 64; ++c) {
        tma_load(base + L::kQ + c * L::kQSlabBytes, &q_map, qdo_full, c * 64, row0 + qt * kRows);
        tma_load(base + L::kDo + c * L::kQSlabBytes, &do_map, qdo_full, c * 64, row0 + qt * kRows);
      }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kDqStages;
        if (j >= kDqStages) mbar_wait(empty + 8 * s, ((j / kDqStages) & 1) ^ 1);
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, 2 * L::kKvBytes);
        for (int c = 0; c < D / 64; ++c) {
          const uint32_t off = s * L::kKvBytes + c * L::kKvSlabBytes;
          tma_load(base + L::kK + off, &k_map, bar, c * 64, row0 + j * kKRows);
          tma_load(base + L::kV + off, &v_map, bar, c * 64, row0 + j * kKRows);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int half = threadIdx.x / kWarpgroup - 1;
    const int warp = (threadIdx.x % kWarpgroup) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = warp * 16 + g;  // this thread's rows r0, r0 + 8 of its warpgroup's 64
    const int row = qt * kRows + half * 64 + r0;
    const uint32_t q_rows = base + L::kQ + half * 64 * kSwizzleRow;
    const uint32_t do_rows = base + L::kDo + half * 64 * kSwizzleRow;
    const float scale2 = scale * kLog2e;
    const float* lr = lse + row0 + row;
    const float* dr = delta + row0 + row;
    const float l0 = lr[0] * kLog2e, l1 = lr[8] * kLog2e, de0 = dr[0], de1 = dr[8];
    // the K tile on this warpgroup's diagonal; causal tiles past it are all masked
    const int diag_tile = causal ? 2 * qt + half : -1;
    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
    mbar_wait(qdo_full, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % kDqStages;
      // every consumer warp waits and arrives on every tile, the masked
      // ones too: the producer's ring counts 8 arrivals a stage
      mbar_wait(full + 8 * s, (j / kDqStages) & 1);
      if (!causal || j <= diag_tile) {
        const uint32_t k_tile = base + L::kK + s * L::kKvBytes;
        const uint32_t v_tile = base + L::kV + s * L::kKvBytes;
        // s = Q K^T and dp = dO V^T: [64 rows, 64 keys] each, two groups
        float sc[32], dp[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wgmma_ss_n64(sc, desc(q_rows + (kk / 4) * L::kQSlabBytes + (kk % 4) * 32, 16, 1024),
                       desc(k_tile + (kk / 4) * L::kKvSlabBytes + (kk % 4) * 32, 16, 1024), kk);
        }
        wg_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wgmma_ss_n64(dp, desc(do_rows + (kk / 4) * L::kQSlabBytes + (kk % 4) * 32, 16, 1024),
                       desc(v_tile + (kk / 4) * L::kKvSlabBytes + (kk % 4) * 32, 16, 1024), kk);
        }
        wg_commit();
        wg_wait<1>();
        pin(sc);
        // p = exp(scale s - lse), 0 above the diagonal
        const bool diag = j == diag_tile;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[4 * n + e] = (diag && n * 8 + 2 * t + (e & 1) > r0 + (e >= 2 ? 8 : 0))
                                ? 0.f
                                : exp2f(fmaf(sc[4 * n + e], scale2, e >= 2 ? -l1 : -l0));
          }
        }
        wg_wait<0>();
        pin(dp);
        // ds = p (dp - delta) scale
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[4 * n + e] = sc[4 * n + e] * (dp[4 * n + e] - (e >= 2 ? de1 : de0)) * scale;
          }
        }
        // dQ += bf16(ds) K: 4 k16 steps over the tile's keys, K read MN-major
        uint32_t fr[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc_to_frag(fr[kk], sc, kk);
        pin(dq_acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs<D>(dq_acc, fr[kk], desc(k_tile + kk * 16 * kSwizzleRow, L::kKvSlabBytes, 1024));
        }
        wg_commit();
        wg_wait<0>();
        pin(dq_acc);
        pin(fr);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    bf16* d0 = dq + (static_cast<size_t>(row0) + row) * D;
    bf16* d1 = d0 + 8 * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(d0 + col) = pack_bf16(dq_acc[4 * n], dq_acc[4 * n + 1]);
      *reinterpret_cast<uint32_t*>(d1 + col) = pack_bf16(dq_acc[4 * n + 2], dq_acc[4 * n + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: tiled kernels on the CUDA cores (FFMA; TF32 would round the operands)
//
// A block of 256 threads owns one 64-row tile. Every product it computes is
// a 64 x 64 (or 64 x D) output; thread (ty, tx) = (tid / 16, tid % 16)
// holds the 4 x 4 sub-tile at rows ty*4.., cols tx*4.. of it in registers
// and accumulates it SGEMM-style, one rank-1 update a step: the A operand
// is staged in shared memory as [K][rows], the B operand as [K][cols], so a
// step reads one float4 of each (the A read is a broadcast across the 16
// threads of a row) and issues 16 FMAs. The 16 threads that share a row are
// 16 lanes of one warp: row max and row sum reduce with four shuffles.
// Operands whose contraction axis is D are staged transposed ([D][64]);
// P and dS are written to shared memory as [64][64 + 4] for the product
// that follows. No atomics: the dK/dV kernel owns its key rows and the dQ
// kernel its query rows, so results repeat bit for bit.

constexpr int kThreadsF32 = 256;  // 16 x 16 threads, a 4 x 4 sub-tile each
constexpr int kLdP = kTile + 4;   // P / dS rows: padded, 16-byte aligned

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// a [kTile, D] tile of a row-major [S, D] f32 matrix into shared memory as is
template <int D>
__device__ __forceinline__ void load_f32(float* dst, const float* src) {
  for (int c = threadIdx.x; c < kTile * D / 4; c += kThreadsF32) {
    const int r = c / (D / 4), col = (c % (D / 4)) * 4;
    *reinterpret_cast<float4*>(dst + r * D + col) = ld4(src + static_cast<size_t>(r) * D + col);
  }
}

// the same tile transposed, dst[col][row], each element times `mul`;
// neighbouring threads take neighbouring rows, so the stores hit 32 banks
template <int D>
__device__ __forceinline__ void load_f32_t(float* dst, const float* src, float mul) {
  for (int c = threadIdx.x; c < kTile * D / 4; c += kThreadsF32) {
    const int r = c % kTile, col = (c / kTile) * 4;
    const float4 x = ld4(src + static_cast<size_t>(r) * D + col);
    dst[(col + 0) * kTile + r] = x.x * mul;
    dst[(col + 1) * kTile + r] = x.y * mul;
    dst[(col + 2) * kTile + r] = x.z * mul;
    dst[(col + 3) * kTile + r] = x.w * mul;
  }
}

// acc[i][j] += sum_{k < K} a[k][ty*4 + i] * b[k][tx*4 + j]
template <int K>
__device__ __forceinline__ void ffma_tile(float (&acc)[4][4], const float* a, int lda,
                                          const float* b, int ldb, int ty, int tx) {
  a += ty * 4;
  b += tx * 4;
#pragma unroll 16
  for (int k = 0; k < K; ++k) {
    const float4 av = ld4(a + k * lda), bv = ld4(b + k * ldb);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4][4]) {
#pragma unroll
  for (int g = 0; g < N; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[g][i][0] = acc[g][i][1] = acc[g][i][2] = acc[g][i][3] = 0.f;
  }
}

// a 4 x 4 sub-tile as column jj of a [64][kLdP] matrix at rows ty*4..ty*4+3:
// thread (ty, tx) writes dst[tx*4 + jj][ty*4 + i] = v[i][jj]
__device__ __forceinline__ void store_t(float* dst, const float (&v)[4][4], int ty, int tx) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    st4(dst + (tx * 4 + jj) * kLdP + ty * 4, v[0][jj], v[1][jj], v[2][jj], v[3][jj]);
  }
}

__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// a [kTile, D] tile of a row-major f32 output from acc[g][i][c] (row
// ty*4 + i, column g*64 + tx*4 + c), each value divided by div[i]
template <int D>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[D / 64][4][4],
                                           const float (&div)[4], int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = dst + static_cast<size_t>(ty * 4 + i) * D + tx * 4;
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
      st4(row + g * 64, acc[g][i][0] / div[i], acc[g][i][1] / div[i], acc[g][i][2] / div[i],
          acc[g][i][3] / div[i]);
    }
  }
}

template <int D>
constexpr int fwd_f32_smem_bytes() {
  return (3 * D * kTile + kTile * kLdP) * 4;
}
template <int D>
constexpr int dq_f32_smem_bytes() {
  return (5 * D * kTile + kTile * kLdP) * 4;
}
template <int D>
constexpr int dkv_f32_smem_bytes() {
  return (6 * D * kTile + kTile * kLdP) * 4;
}

// forward: the block owns Q tile qt and streams K/V tiles up to the diagonal
template <int D>
__global__ void __launch_bounds__(kThreadsF32)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int seq, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qt_s = reinterpret_cast<float*>(smem_raw);  // [D][kTile], q * scale
  float* kt_s = qt_s + D * kTile;                    // [D][kTile]
  float* v_s = kt_s + D * kTile;                     // [kTile][D]
  float* pt_s = v_s + kTile * D;                     // [kTile keys][kLdP]
  const int n_tiles = seq / kTile;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);  // longest rows first
  const size_t head = static_cast<size_t>(blockIdx.y) * seq * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_f32_t<D>(qt_s, q + head + static_cast<size_t>(qt) * kTile * D, scale);
  float acc[D / 64][4][4];
  zero(acc);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kNeg, l[i] = 0.f;
  const int last = causal ? qt : n_tiles - 1;
  for (int j = 0; j <= last; ++j) {
    __syncthreads();  // the previous tile and its P are consumed
    const size_t off = head + static_cast<size_t>(j) * kTile * D;
    load_f32_t<D>(kt_s, k + off, 1.f);
    load_f32<D>(v_s, v + off);
    __syncthreads();
    float s[4][4] = {};
    ffma_tile<D>(s, qt_s, kTile, kt_s, kTile, ty, tx);
    const bool diag = causal && j == qt;
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (diag && tx * 4 + jj > ty * 4 + i) s[i][jj] = kNeg;
        mx = fmaxf(mx, s[i][jj]);
      }
      mx = max16(mx);
      alpha[i] = expf(m[i] - mx);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[i][jj] = expf(s[i][jj] - mx);
        rs += s[i][jj];
      }
      l[i] = alpha[i] * l[i] + sum16(rs);
      m[i] = mx;
    }
    store_t(pt_s, s, ty, tx);
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[g][i][c] *= alpha[i];
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < D / 64; ++g) ffma_tile<kTile>(acc[g], pt_s, kLdP, v_s + g * 64, D, ty, tx);
  }
  store_rows<D>(o + head + static_cast<size_t>(qt) * kTile * D, acc, l, ty, tx);
  if (tx == 0) {
    float* lr = lse + static_cast<size_t>(blockIdx.y) * seq + qt * kTile + ty * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) lr[i] = m[i] + logf(l[i]);
  }
}

// dQ: the block owns Q tile qt and streams K/V tiles up to the diagonal
template <int D>
__global__ void __launch_bounds__(kThreadsF32)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int seq, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qt_s = reinterpret_cast<float*>(smem_raw);  // [D][kTile]
  float* dot_s = qt_s + D * kTile;                   // [D][kTile]
  float* kt_s = dot_s + D * kTile;                   // [D][kTile]
  float* vt_s = kt_s + D * kTile;                    // [D][kTile]
  float* k_s = vt_s + D * kTile;                     // [kTile][D]
  float* dst_s = k_s + kTile * D;                    // [kTile keys][kLdP]
  const int n_tiles = seq / kTile;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);
  const size_t head = static_cast<size_t>(blockIdx.y) * seq * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const size_t qoff = head + static_cast<size_t>(qt) * kTile * D;
  load_f32_t<D>(qt_s, q + qoff, 1.f);
  load_f32_t<D>(dot_s, dout + qoff, 1.f);
  const size_t rows = static_cast<size_t>(blockIdx.y) * seq + qt * kTile + ty * 4;
  const float4 l4 = ld4(lse + rows), d4 = ld4(delta + rows);
  const float lr[4] = {l4.x, l4.y, l4.z, l4.w}, dr[4] = {d4.x, d4.y, d4.z, d4.w};
  float acc[D / 64][4][4];
  zero(acc);
  const int last = causal ? qt : n_tiles - 1;
  for (int j = 0; j <= last; ++j) {
    __syncthreads();
    const size_t off = head + static_cast<size_t>(j) * kTile * D;
    load_f32_t<D>(kt_s, k + off, 1.f);
    load_f32_t<D>(vt_s, v + off, 1.f);
    load_f32<D>(k_s, k + off);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    ffma_tile<D>(s, qt_s, kTile, kt_s, kTile, ty, tx);
    ffma_tile<D>(dp, dot_s, kTile, vt_s, kTile, ty, tx);
    const bool diag = causal && j == qt;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = (diag && tx * 4 + jj > ty * 4 + i) ? 0.f : expf(scale * s[i][jj] - lr[i]);
        s[i][jj] = p * (dp[i][jj] - dr[i]) * scale;
      }
    }
    store_t(dst_s, s, ty, tx);
    __syncthreads();
#pragma unroll
    for (int g = 0; g < D / 64; ++g) ffma_tile<kTile>(acc[g], dst_s, kLdP, k_s + g * 64, D, ty, tx);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<D>(dq + qoff, acc, one, ty, tx);
}

// dK/dV: the block owns K tile kt and streams Q/dO tiles from the diagonal;
// every product is computed transposed (rows = keys)
template <int D>
__global__ void __launch_bounds__(kThreadsF32)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int seq,
                         float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* kt_s = reinterpret_cast<float*>(smem_raw);  // [D][kTile]
  float* vt_s = kt_s + D * kTile;                    // [D][kTile]
  float* qt_s = vt_s + D * kTile;                    // [D][kTile]
  float* dot_s = qt_s + D * kTile;                   // [D][kTile]
  float* q_s = dot_s + D * kTile;                    // [kTile][D]
  float* do_s = q_s + kTile * D;                     // [kTile][D]
  float* ps_s = do_s + kTile * D;                    // [kTile queries][kLdP]: P, then dS
  const int n_tiles = seq / kTile;
  const int kt = blockIdx.x;  // causal: low K tiles see the most Q tiles
  const size_t head = static_cast<size_t>(blockIdx.y) * seq * D;
  const float* lse_h = lse + static_cast<size_t>(blockIdx.y) * seq;
  const float* delta_h = delta + static_cast<size_t>(blockIdx.y) * seq;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const size_t koff = head + static_cast<size_t>(kt) * kTile * D;
  load_f32_t<D>(kt_s, k + koff, 1.f);
  load_f32_t<D>(vt_s, v + koff, 1.f);
  float dk_acc[D / 64][4][4], dv_acc[D / 64][4][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int qi = causal ? kt : 0; qi < n_tiles; ++qi) {
    __syncthreads();
    const size_t off = head + static_cast<size_t>(qi) * kTile * D;
    load_f32_t<D>(qt_s, q + off, 1.f);
    load_f32_t<D>(dot_s, dout + off, 1.f);
    load_f32<D>(q_s, q + off);
    load_f32<D>(do_s, dout + off);
    const float4 l4 = ld4(lse_h + qi * kTile + tx * 4), d4 = ld4(delta_h + qi * kTile + tx * 4);
    const float lq[4] = {l4.x, l4.y, l4.z, l4.w}, dl[4] = {d4.x, d4.y, d4.z, d4.w};
    __syncthreads();
    // s^T = K Q^T and dp^T = V dO^T: [key ty*4 + i][query tx*4 + jj]
    float st[4][4] = {}, dpt[4][4] = {};
    ffma_tile<D>(st, kt_s, kTile, qt_s, kTile, ty, tx);
    ffma_tile<D>(dpt, vt_s, kTile, dot_s, kTile, ty, tx);
    const bool diag = causal && qi == kt;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        st[i][jj] = (diag && tx * 4 + jj < ty * 4 + i) ? 0.f : expf(scale * st[i][jj] - lq[jj]);
      }
    }
    store_t(ps_s, st, ty, tx);  // P [query][key]
    __syncthreads();
#pragma unroll
    for (int g = 0; g < D / 64; ++g) ffma_tile<kTile>(dv_acc[g], ps_s, kLdP, do_s + g * 64, D, ty, tx);
    __syncthreads();  // P is consumed; dS takes its place
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) st[i][jj] = st[i][jj] * (dpt[i][jj] - dl[jj]) * scale;
    }
    store_t(ps_s, st, ty, tx);
    __syncthreads();
#pragma unroll
    for (int g = 0; g < D / 64; ++g) ffma_tile<kTile>(dk_acc[g], ps_s, kLdP, q_s + g * 64, D, ty, tx);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<D>(dk + koff, dk_acc, one, ty, tx);
  store_rows<D>(dv + koff, dv_acc, one, ty, tx);
}

// ---------------------------------------------------------------------------
// launchers

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename K, typename... Args>
int launch(K kernel, int threads, int smem, int seq, int bh, cudaStream_t st, Args... args) {
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(seq / kTile, bh), threads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime: the library
// links against no libcuda of its own
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a 2D map of the row-major [rows, D] bf16 matrix at ptr, in boxes of
// [box_rows, 64] with the 128-byte swizzle that the wgmma descriptors read
bool bf16_map(CUtensorMap* map, const void* ptr, uint64_t rows, int d, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), rows};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * sizeof(bf16)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the TMA kernels: grid (heads, tiles), so that every head's first tile
// (the longest rows, or the K tile with the most Q tiles) is scheduled first
template <typename K, typename... Args>
int launch_tma(K kernel, int smem, int tiles, int bh, cudaStream_t st, Args... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(bh, tiles), kHopperThreads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 TMA kernels take S % 128 == 0 and address rows of the [BH S, D]
// view with 32-bit TMA coordinates
bool tma_shapes_ok(int bh, int seq) {
  return seq % kRows == 0 && static_cast<int64_t>(bh) * seq <= INT32_MAX;
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int seq,
        float scale, int causal, int dtype, cudaStream_t st) {
  float* l = static_cast<float*>(lse);
  if (dtype == kBF16) {
    const uint64_t rows = static_cast<uint64_t>(bh) * seq;
    CUtensorMap qm, km, vm;
    if (!tma_shapes_ok(bh, seq) || !bf16_map(&qm, q, rows, D, kRows) ||
        !bf16_map(&km, k, rows, D, kRows) || !bf16_map(&vm, v, rows, D, kRows)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_tma(flash_fwd_bf16_kernel<D>, FwdLayout<D>::kBytes, seq / kRows, bh, st, qm, km,
                      vm, static_cast<bf16*>(o), l, seq, scale, causal);
  }
  return launch(flash_fwd_f32_kernel<D>, kThreadsF32, fwd_f32_smem_bytes<D>(), seq, bh, st,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<float*>(o), l, seq, scale, causal);
}

template <int D>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
            const void* delta, void* dk, void* dv, int bh, int seq, float scale, int causal,
            int dtype, cudaStream_t st) {
  const float* l = static_cast<const float*>(lse);
  const float* de = static_cast<const float*>(delta);
  if (dtype == kBF16) {
    const uint64_t rows = static_cast<uint64_t>(bh) * seq;
    CUtensorMap qm, km, vm, dom;
    if (!tma_shapes_ok(bh, seq) || !bf16_map(&qm, q, rows, D, kQRows) ||
        !bf16_map(&km, k, rows, D, kRows) || !bf16_map(&vm, v, rows, D, kRows) ||
        !bf16_map(&dom, dout, rows, D, kQRows)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_tma(flash_bwd_dkv_bf16_kernel<D>, DkvLayout<D>::kBytes, seq / kRows, bh, st, qm,
                      km, vm, dom, l, de, static_cast<bf16*>(dk), static_cast<bf16*>(dv), seq,
                      scale, causal);
  }
  return launch(flash_bwd_dkv_f32_kernel<D>, kThreadsF32, dkv_f32_smem_bytes<D>(), seq, bh, st,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(dout), l, de,
                static_cast<float*>(dk), static_cast<float*>(dv), seq, scale, causal);
}

template <int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, int bh, int seq, float scale, int causal, int dtype,
           cudaStream_t st) {
  const float* l = static_cast<const float*>(lse);
  const float* de = static_cast<const float*>(delta);
  if (dtype == kBF16) {
    const uint64_t rows = static_cast<uint64_t>(bh) * seq;
    CUtensorMap qm, km, vm, dom;
    if (!tma_shapes_ok(bh, seq) || !bf16_map(&qm, q, rows, D, kRows) ||
        !bf16_map(&km, k, rows, D, kKRows) || !bf16_map(&vm, v, rows, D, kKRows) ||
        !bf16_map(&dom, dout, rows, D, kRows)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_tma(flash_bwd_dq_bf16_kernel<D>, DqLayout<D>::kBytes, seq / kRows, bh, st, qm,
                      km, vm, dom, l, de, static_cast<bf16*>(dq), seq, scale, causal);
  }
  return launch(flash_bwd_dq_f32_kernel<D>, kThreadsF32, dq_f32_smem_bytes<D>(), seq, bh, st,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(dout), l, de,
                static_cast<float*>(dq), seq, scale, causal);
}

bool shapes_ok(int bh, int seq, int head_dim, int dtype) {
  return bh > 0 && bh <= 65535 && seq > 0 && seq % kTile == 0 &&
         (head_dim == 64 || head_dim == 128) && (dtype == kF32 || dtype == kBF16);
}

}  // namespace

// Each entry point launches one kernel on `stream`, does not synchronise,
// allocates nothing, and returns cudaGetLastError() (0 when the launch was
// accepted). Arguments the kernels do not take return cudaErrorInvalidValue
// unlaunched. The backward is two entry points: dK/dV, then dQ.

extern "C" int pdt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, int bh, int seq, int head_dim, float scale,
                             int causal, int dtype, void* stream) {
  if (!shapes_ok(bh, seq, head_dim, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return fwd<64>(q, k, v, o, lse, bh, seq, scale, causal, dtype, st);
  return fwd<128>(q, k, v, o, lse, bh, seq, scale, causal, dtype, st);
}

extern "C" int pdt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dk, void* dv, int bh, int seq, int head_dim,
                                 float scale, int causal, int dtype, void* stream) {
  if (!shapes_ok(bh, seq, head_dim, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    return bwd_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh, seq, scale, causal, dtype, st);
  }
  return bwd_dkv<128>(q, k, v, dout, lse, delta, dk, dv, bh, seq, scale, causal, dtype, st);
}

extern "C" int pdt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                void* dq, int bh, int seq, int head_dim, float scale,
                                int causal, int dtype, void* stream) {
  if (!shapes_ok(bh, seq, head_dim, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    return bwd_dq<64>(q, k, v, dout, lse, delta, dq, bh, seq, scale, causal, dtype, st);
  }
  return bwd_dq<128>(q, k, v, dout, lse, delta, dq, bh, seq, scale, causal, dtype, st);
}
