// Flash attention, forward and backward, written by hand for Hopper
// (sm_90a), with a plain C interface that the Python side binds with ctypes
// (pytorch_distributed_training_tpu_torch/kernels/__init__.py).
//
// q, k, v, o, dO, dq, dk, dv are [BH, S, D] (heads folded into the batch),
// lse and delta are [BH, S] f32. D is 64 or 128; S is a multiple of 128 in
// bf16 (the tiles of the TMA kernels) and of 64 in f32.
//
// The forward (pdt_flash_fwd: flash_fwd_bf16_kernel, flash_fwd_3xtf32_kernel)
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
// (pdt_flash_bwd_dkv: flash_bwd_dkv_bf16_kernel, _3xtf32_kernel) that owns a K
// tile and loops over Q tiles, and a dQ kernel (pdt_flash_bwd_dq:
// flash_bwd_dq_bf16_kernel, _3xtf32_kernel) that owns a Q tile and loops over K
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
// - f32 inputs: q * scale before the dot in the forward (:188), scale *
//   (q . k) in the backward (:256, :319; the kernels fold the scale into
//   one operand, which changes only the rounding order); p stays f32 into
//   P V (:216). The forward, dK/dV and dQ run on the tensor cores in
//   3xTF32 (each f32 operand split into a TF32 part and a TF32 remainder,
//   three TF32 products a step, each product off by about 2^-22 of its
//   size).
//
// Bound: operations (`flash_flops` in ops/flash_attention.py: 2 S D
// multiply-adds x 2 per kept (query, key) pair and product; the forward has
// 2 products, dK/dV 4, dQ 3). At the LM's shape (BH 128, S 2048, D 64,
// causal) the forward is 68.7 GFLOP (0.069 ms at 989 TFLOP/s bf16) against
// 135 MB of traffic (0.04 ms at 3.35 TB/s); dK/dV is 137.4 GFLOP, dQ 103.1
// GFLOP (0.104 ms) against 170 MB (0.05 ms). In f32 the same work runs at
// most at 494.7 / 3 = 164.9 TFLOP/s (3xTF32 on the tensor cores: 0.417 ms
// for that forward), and at 67 TFLOP/s as FFMA on the CUDA cores.
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
// f32 designs: see the f32 sections (the 3xTF32 forward, dK/dV and dQ).

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
// f32 forward on the tensor cores: 3xTF32 with mma.sync m16n8k8
//
// Replaces the tiled FFMA forward, which reached 39% of the 67 TFLOP/s of
// the CUDA cores. The tensor cores multiply TF32 (10 mantissa bits) at
// 494.7 TFLOP/s dense, so an f32-accurate product taken as three TF32
// products runs at up to 164.9: each operand x is split into big = tf32(x)
// and small = tf32(x - big), both rounded to nearest with ties away from
// zero (the bits of cvt.rna.tf32.f32), and a step adds a_small b_big +
// a_big b_small + a_big b_big, the small products first (CUTLASS's
// OpMultiplyAddFastF32, which PyTorch's own f32 attention takes on sm80
// and later). big + small is x within 2^-22 |x|; the dropped a_small
// b_small is below 2^-22 of the product. tools/flash_checks.py repeats this
// arithmetic in PyTorch.
//
// A block of 4 warps owns a 64-row Q tile, 16 rows a warp, and streams
// K/V tiles of kKeys rows (32 at D = 64, 64 at D = 128) through a 2-stage
// cp.async ring: 16-byte cp.async.cg copies, one commit group and one
// barrier a tile; the copy of tile j + 1 is issued after the barrier that
// ends every warp's use of its stage, and runs under tile j's math. At
// D = 64 three blocks fit an SM (68 KB of shared memory, at most 168
// registers by the launch bounds; 64-key tiles fit two and ran 8% slower on
// the H100), at D = 128 one.
// Tiles keep their row-major layout with rows padded to D + 4 floats, so
// that every fragment load below is free of bank conflicts ((4 g + t) and
// (8 t + g) cover the 32 banks). mma.sync reads its operands from
// registers, which each lane loads from shared memory by itself: no
// transposed copy, no swizzle, no TMA.
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4): A a0..a3 = A[g][t],
// A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]; B b0, b1 = B[t][g], B[t + 4][g];
// C c0..c3 = C[g][2t], C[g][2t + 1], C[g + 8][2t], C[g + 8][2t + 1].
// - S = Q K^T: A is q * scale, split once into two shared-memory planes
//   (big and small) that the warps read a k-step at a time; B[t][g] is
//   K[g][t], read from the K tile and split per warp.
// - O += P V: P stays in the registers of S's C fragments. A product
//   contracts over the 8 keys of a step in any order, so the step takes
//   key 2t as its k = t and key 2t + 1 as its k = t + 4: then A is
//   {c0, c2, c1, c3} of S's fragment as it stands (no shuffle, no shared
//   memory), and B is V[2t][g], V[2t + 1][g] of the V tile.
// The tensor cores add an mma.sync's products into its f32 accumulator by
// truncation, not to nearest as an FFMA rounds, so a long chain of them into
// one accumulator drifts: with O accumulated across all K/V tiles, o was off
// from the twin by 5.4e-5 (norm-relative) at S = 32768, over the 1e-5
// limit. Each tile's P V therefore starts from zero (64 columns of O at a
// time) and is added to O by an f32 FMA, O = alpha O + P V, as the FFMA
// kernel rounded: 1.4e-6 there. The two small products of a step go to an
// accumulator of their own, added to the big one once a tile: the two
// chains no longer wait on each other, and the small sums are not truncated
// at the big one's exponent (3-4% faster on the H100, and o 5.0e-7 from the
// twin, not 7.5e-7, at [8, 16, 2048, 64]). Splitting K and V once a stage
// into shared planes instead of per warp ran 16% slower (two barriers a
// tile, two blocks an SM at D = 64).
// Online softmax in registers: a row's scores of a tile lie in the 4 lanes
// of a quad (rows g and g + 8), reduced with two xor shuffles; expf and
// logf as in the FFMA kernel; the -1e30 mask on the tiles the diagonal
// crosses only.

constexpr int kThreads3x = 128;  // 4 warps, 16 query rows each

template <int D>
struct Fwd3xLayout {
  static constexpr int kKeys = D == 64 ? 32 : 64;  // K/V rows a tile
  static constexpr int kLd = D + 4;  // floats a staged row
  static constexpr int kKvFloats = kKeys * kLd;
  static constexpr int kQFloats = kTile * kLd;
  // 2 stages of K and V, then Q's big and small planes
  static constexpr int kBytes = (4 * kKvFloats + 2 * kQFloats) * 4;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// a [R, D] tile of a row-major [S, D] f32 matrix into shared memory with
// rows of D + 4 floats, 16 bytes a copy, neighbouring threads on
// neighbouring addresses
template <int R, int D>
__device__ __forceinline__ void stage_f32(float* dst, const float* src) {
#pragma unroll
  for (int i = 0; i < R * D / 4 / kThreads3x; ++i) {
    const int c = threadIdx.x + i * kThreads3x;
    const int r = c / (D / 4), col = (c % (D / 4)) * 4;
    cp_async16(dst + r * (D + 4) + col, src + static_cast<size_t>(r) * D + col);
  }
}

// x rounded to TF32, to nearest with ties away from zero: the bits of
// cvt.rna.tf32.f32 for every finite x (adding half a TF32 ulp to the
// magnitude bits carries into the kept ones exactly when x rounds up) in two
// integer instructions, where ptxas spends four on the cvt and its NaN test
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small within 2^-22 |x|, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a b in 3xTF32: c_small += a_small b_big + a_big b_small (the small
// products first), c += a_big b_big; the caller adds c_small to c
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], float (&c_small)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], float b0, float b1) {
  uint32_t big[2], small[2];
  split_tf32(b0, big[0], small[0]);
  split_tf32(b1, big[1], small[1]);
  mma_tf32(c_small, a_small, big);
  mma_tf32(c_small, a_big, small);
  mma_tf32(c, a_big, big);
}

// the block owns Q tile qt and streams K/V tiles up to the diagonal
template <int D>
__global__ void __launch_bounds__(kThreads3x, D == 64 ? 3 : 1)
flash_fwd_3xtf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int seq, float scale, int causal) {
  using L = Fwd3xLayout<D>;
  constexpr int kLd = L::kLd, kKeys = L::kKeys;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);  // [stage][K, V][kKeys][kLd]
  float* q_big = ring + 4 * L::kKvFloats;            // [kTile][kLd] each
  float* q_small = q_big + L::kQFloats;
  const int qt = seq / kTile - 1 - static_cast<int>(blockIdx.x);  // longest rows first
  const size_t head = static_cast<size_t>(blockIdx.y) * seq * D;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int row = warp * 16 + g;  // this lane's first row in the tile; the second is row + 8
  const int q_row = qt * kTile + row;
  // the last K/V tile: causal, the one that holds the tile's last row
  const int last = causal ? ((qt + 1) * kTile - 1) / kKeys : seq / kKeys - 1;

  auto stage_kv = [&](int j) {
    float* dst = ring + (j & 1) * 2 * L::kKvFloats;
    const size_t off = head + static_cast<size_t>(j) * kKeys * D;
    stage_f32<kKeys, D>(dst, k + off);
    stage_f32<kKeys, D>(dst + L::kKvFloats, v + off);
    cp_async_commit();
  };
  stage_kv(0);

  // q * scale split into two planes; the loop's first barrier publishes them
  const float* q_tile = q + head + static_cast<size_t>(qt) * kTile * D;
#pragma unroll
  for (int i = 0; i < kTile * D / 4 / kThreads3x; ++i) {
    const int c = threadIdx.x + i * kThreads3x;
    const int r = c / (D / 4), col = (c % (D / 4)) * 4;
    const float4 x = ld4(q_tile + static_cast<size_t>(r) * D + col);
    const float xs[4] = {x.x * scale, x.y * scale, x.z * scale, x.w * scale};
    uint32_t big[4], small[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(xs[e], big[e], small[e]);
    *reinterpret_cast<uint4*>(q_big + r * kLd + col) = make_uint4(big[0], big[1], big[2], big[3]);
    *reinterpret_cast<uint4*>(q_small + r * kLd + col) =
        make_uint4(small[0], small[1], small[2], small[3]);
  }

  float acc[D / 8][4] = {};  // O: rows row, row + 8; columns 8 n + 2 t, + 1
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  for (int j = 0; j <= last; ++j) {
    cp_async_wait_all();  // this thread's copies of tile j
    __syncthreads();      // everyone's; and every warp is done with tile j - 1
    if (j < last) stage_kv(j + 1);
    const float* k_s = ring + (j & 1) * 2 * L::kKvFloats;
    const float* v_s = k_s + L::kKvFloats;

    float s[kKeys / 8][4] = {};  // S: rows row, row + 8; keys 8 n + 2 t, + 1
    float s_small[kKeys / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int at = row * kLd + 8 * kk + t;
      const int offs[4] = {at, at + 8 * kLd, at + 4, at + 8 * kLd + 4};
      uint32_t a_big[4], a_small[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a_big[e] = __float_as_uint(q_big[offs[e]]);
        a_small[e] = __float_as_uint(q_small[offs[e]]);
      }
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
        const float* kp = k_s + (8 * n + g) * kLd + 8 * kk + t;  // B[t][g] = K[g][t]
        mma_3xtf32(s[n], s_small[n], a_big, a_small, kp[0], kp[4]);
      }
    }
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += s_small[n][e];
    }

    if (causal && (j + 1) * kKeys > qt * kTile) {  // tiles the diagonal crosses
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = j * kKeys + 8 * n + 2 * t + e;
          if (key > q_row) s[n][e] = kNeg;
          if (key > q_row + 8) s[n][2 + e] = kNeg;
        }
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float alpha0 = expf(m0 - mx0), alpha1 = expf(m1 - mx1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
      s[n][0] = expf(s[n][0] - mx0);
      s[n][1] = expf(s[n][1] - mx0);
      s[n][2] = expf(s[n][2] - mx1);
      s[n][3] = expf(s[n][3] - mx1);
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
    }
    l0 = alpha0 * l0 + quad_sum(rs0);
    l1 = alpha1 * l1 + quad_sum(rs1);
    m0 = mx0;
    m1 = mx1;

    // P V of this tile into a fresh accumulator, 64 columns of O at a time,
    // then O = alpha O + P V in f32 registers (see above)
#pragma unroll
    for (int h = 0; h < D / 64; ++h) {
      float pv[8][4] = {}, pv_small[8][4] = {};
#pragma unroll
      for (int kk = 0; kk < kKeys / 8; ++kk) {
        // keys 8 kk + 2 t and 8 kk + 2 t + 1 as k = t and t + 4 (see above)
        uint32_t p_big[4], p_small[4];
        split_tf32(s[kk][0], p_big[0], p_small[0]);
        split_tf32(s[kk][2], p_big[1], p_small[1]);
        split_tf32(s[kk][1], p_big[2], p_small[2]);
        split_tf32(s[kk][3], p_big[3], p_small[3]);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float* vp = v_s + (8 * kk + 2 * t) * kLd + 64 * h + 8 * n + g;
          mma_3xtf32(pv[n], pv_small[n], p_big, p_small, vp[0], vp[kLd]);
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float (&a)[4] = acc[8 * h + n];
        a[0] = fmaf(a[0], alpha0, pv[n][0] + pv_small[n][0]);
        a[1] = fmaf(a[1], alpha0, pv[n][1] + pv_small[n][1]);
        a[2] = fmaf(a[2], alpha1, pv[n][2] + pv_small[n][2]);
        a[3] = fmaf(a[3], alpha1, pv[n][3] + pv_small[n][3]);
      }
    }
  }

  float* o0 = o + head + static_cast<size_t>(q_row) * D + 2 * t;
  float* o1 = o0 + 8 * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<float2*>(o0 + 8 * n) = make_float2(acc[n][0] / l0, acc[n][1] / l0);
    *reinterpret_cast<float2*>(o1 + 8 * n) = make_float2(acc[n][2] / l1, acc[n][3] / l1);
  }
  if (t == 0) {
    float* lr = lse + static_cast<size_t>(blockIdx.y) * seq + q_row;
    lr[0] = m0 + logf(l0);
    lr[8] = m1 + logf(l1);
  }
}

// ---------------------------------------------------------------------------
// f32 dK/dV on the tensor cores: 3xTF32 with mma.sync m16n8k8
//
// Replaces TPU kernels K2e and K2g in f32, `_dkv_kernel`
// (pytorch_distributed_training_tpu/ops/flash_attention.py:348) and
// `_dkv_stream_kernel` (:506), and the tiled FFMA dK/dV before it, which
// reached 41% of the 67 TFLOP/s of the CUDA cores (4.95 ms against an FFMA
// bound of 2.05 ms at [8, 16, 2048, 64] causal on the H100): only the
// tensor cores can go below that. Bound: flash_flops(part="dkv"), four
// products over the kept (query, key) pairs, at 164.9 TFLOP/s (3xTF32, see
// the forward above): 0.834 ms at that shape. Every product is taken in
// 3xTF32 as in the forward, with the same split, rounding and fragment
// loads.
//
// A block of 4 warps owns a 64-row K tile, 16 keys a warp (kt =
// blockIdx.x: causal, the low K tiles see the most Q tiles and go first),
// and computes every product transposed, keys as rows:
// - S^T = (scale K) Q^T and dP^T = V dO^T: A is the warp's 16 rows of K
//   (times scale) or V, split once, before the loop, into big and small
//   shared-memory planes with rows of D + 4 floats; B[t][g] is Q[g][t] (or
//   dO[g][t]), read from the streamed tile as the forward reads K, and
//   split per warp.
// - P^T = exp(S^T - lse[query]) and dS^T = P^T (dP^T - delta[query]) scale
//   stay in the registers of S^T's and dP^T's C fragments; the mask (p = 0
//   where query < key, as exp(-1e30 - lse) is) only on the Q tiles the
//   diagonal crosses.
// - dV += P^T dO and dK += dS^T Q contract over the tile's queries: the
//   step takes query 2t as k = t and query 2t + 1 as k = t + 4, so A is
//   {c0, c2, c1, c3} of P^T's (dS^T's) fragment as it stands, and B is
//   dO[2t][g], dO[2t + 1][g] (Q's), read as the forward reads V.
// Q and dO tiles of kQ = 32 rows, with the lse and delta of those rows,
// stream through a 2-stage cp.async ring: one commit group and one barrier
// a tile, the copy of tile i + 1 issued after the barrier that ends every
// warp's use of its stage. Shared memory: the four K/V planes (68 KB at
// D = 64, 132 KB at D = 128) and the ring (34 KB, 66 KB): two blocks an SM
// at D = 64, one at D = 128.
// A dK/dV row sums over up to S / kQ tiles (1024 at S = 32768), and the
// tensor cores add their products by truncation (the forward's o drifted
// to 5.4e-5 with one chain across all tiles), so each tile's P^T dO and
// dS^T Q start from zero, 64 columns at a time, with the small products in
// an accumulator of their own, and are added to the running dV and dK in
// f32. No atomics: the block owns its key rows, so dk and dv repeat bit
// for bit.

template <int D>
struct Dkv3xLayout {
  static constexpr int kQ = 32;               // query rows a streamed tile
  static constexpr int kLd = D + 4;           // floats a staged row
  static constexpr int kPlane = kTile * kLd;  // a K or V plane
  static constexpr int kQFloats = kQ * kLd;   // a Q or dO tile
  // a stage: Q, dO, then the kQ lse and kQ delta values of its rows
  static constexpr int kStage = 2 * kQFloats + 2 * kQ;
  // K big, K small, V big, V small, then the 2 stages
  static constexpr int kBytes = (4 * kPlane + 2 * kStage) * 4;
};

// out[8 h + n] += A B for the 64 columns of half h, over the R rows of one
// staged tile: A (16 rows) from the C fragments a, whose rows 2t and 2t + 1
// of a k-step serve as k = t and t + 4; B from the tile b_s (rows of D + 4
// floats). The product goes into a fresh accumulator, its small products
// into one of their own, and is added to out in f32.
template <int D, int R>
__device__ __forceinline__ void add_rows_product(float (&out)[D / 8][4], const float (&a)[R / 8][4],
                                                 const float* b_s, int h, int g, int t) {
  float acc[8][4] = {}, acc_small[8][4] = {};
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk) {
    uint32_t a_big[4], a_small[4];
    split_tf32(a[kk][0], a_big[0], a_small[0]);
    split_tf32(a[kk][2], a_big[1], a_small[1]);
    split_tf32(a[kk][1], a_big[2], a_small[2]);
    split_tf32(a[kk][3], a_big[3], a_small[3]);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float* bp = b_s + (8 * kk + 2 * t) * (D + 4) + 64 * h + 8 * n + g;
      mma_3xtf32(acc[n], acc_small[n], a_big, a_small, bp[0], bp[D + 4]);
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) out[8 * h + n][e] += acc[n][e] + acc_small[n][e];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads3x, D == 64 ? 2 : 1)
flash_bwd_dkv_3xtf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv, int seq,
                            float scale, int causal) {
  using L = Dkv3xLayout<D>;
  constexpr int kLd = L::kLd, kQ = L::kQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_big = reinterpret_cast<float*>(smem_raw);  // [kTile][kLd] each
  float* k_small = k_big + L::kPlane;
  float* v_big = k_small + L::kPlane;
  float* v_small = v_big + L::kPlane;
  float* ring = v_small + L::kPlane;  // [stage]: Q, dO [kQ][kLd], lse [kQ], delta [kQ]
  const int kt = blockIdx.x;
  const size_t head = static_cast<size_t>(blockIdx.y) * seq * D;
  const float* lse_h = lse + static_cast<size_t>(blockIdx.y) * seq;
  const float* delta_h = delta + static_cast<size_t>(blockIdx.y) * seq;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int row = warp * 16 + g;  // this lane's first key in the tile; the second is row + 8
  const int key = kt * kTile + row;
  const int first = causal ? kt * kTile / kQ : 0;  // the Q tile that holds query kt * kTile
  const int n_q = seq / kQ;

  auto stage_q = [&](int i) {
    float* dst = ring + (i & 1) * L::kStage;
    const size_t off = head + static_cast<size_t>(i) * kQ * D;
    stage_f32<kQ, D>(dst, q + off);
    stage_f32<kQ, D>(dst + L::kQFloats, dout + off);
    if (threadIdx.x < kQ / 2) {  // kQ / 4 copies of lse, then kQ / 4 of delta
      const int c = threadIdx.x % (kQ / 4), which = threadIdx.x / (kQ / 4);
      cp_async16(dst + 2 * L::kQFloats + which * kQ + 4 * c,
                 (which ? delta_h : lse_h) + static_cast<size_t>(i) * kQ + 4 * c);
    }
    cp_async_commit();
  };
  stage_q(first);

  // K * scale and V split into their planes; the loop's first barrier
  // publishes them
  const size_t koff = head + static_cast<size_t>(kt) * kTile * D;
#pragma unroll
  for (int i = 0; i < kTile * D / 4 / kThreads3x; ++i) {
    const int c = threadIdx.x + i * kThreads3x;
    const int r = c / (D / 4), col = (c % (D / 4)) * 4;
    const float4 xk = ld4(k + koff + static_cast<size_t>(r) * D + col);
    const float4 xv = ld4(v + koff + static_cast<size_t>(r) * D + col);
    const float ks[4] = {xk.x * scale, xk.y * scale, xk.z * scale, xk.w * scale};
    const float vs[4] = {xv.x, xv.y, xv.z, xv.w};
    uint32_t kb[4], ksm[4], vb[4], vsm[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      split_tf32(ks[e], kb[e], ksm[e]);
      split_tf32(vs[e], vb[e], vsm[e]);
    }
    const int at = r * kLd + col;
    *reinterpret_cast<uint4*>(k_big + at) = make_uint4(kb[0], kb[1], kb[2], kb[3]);
    *reinterpret_cast<uint4*>(k_small + at) = make_uint4(ksm[0], ksm[1], ksm[2], ksm[3]);
    *reinterpret_cast<uint4*>(v_big + at) = make_uint4(vb[0], vb[1], vb[2], vb[3]);
    *reinterpret_cast<uint4*>(v_small + at) = make_uint4(vsm[0], vsm[1], vsm[2], vsm[3]);
  }

  // the running dK and dV: keys row, row + 8; columns 8 n + 2 t, + 1
  float dk_acc[D / 8][4] = {}, dv_acc[D / 8][4] = {};
  for (int i = first; i < n_q; ++i) {
    cp_async_wait_all();  // this thread's copies of tile i
    __syncthreads();      // everyone's; and every warp is done with tile i - 1
    if (i + 1 < n_q) stage_q(i + 1);
    const float* q_s = ring + (i & 1) * L::kStage;
    const float* do_s = q_s + L::kQFloats;
    const float* lse_s = do_s + L::kQFloats;
    const float* delta_s = lse_s + kQ;

    // S^T = (scale K) Q^T and dP^T = V dO^T: keys row, row + 8; queries
    // 8 n + 2 t, + 1
    float st[kQ / 8][4] = {}, st_small[kQ / 8][4] = {};
    float dpt[kQ / 8][4] = {}, dpt_small[kQ / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int at = row * kLd + 8 * kk + t;
      const int offs[4] = {at, at + 8 * kLd, at + 4, at + 8 * kLd + 4};
      uint32_t a_big[4], a_small[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a_big[e] = __float_as_uint(k_big[offs[e]]);
        a_small[e] = __float_as_uint(k_small[offs[e]]);
      }
#pragma unroll
      for (int n = 0; n < kQ / 8; ++n) {
        const float* qp = q_s + (8 * n + g) * kLd + 8 * kk + t;  // B[t][g] = Q[g][t]
        mma_3xtf32(st[n], st_small[n], a_big, a_small, qp[0], qp[4]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a_big[e] = __float_as_uint(v_big[offs[e]]);
        a_small[e] = __float_as_uint(v_small[offs[e]]);
      }
#pragma unroll
      for (int n = 0; n < kQ / 8; ++n) {
        const float* op = do_s + (8 * n + g) * kLd + 8 * kk + t;  // B[t][g] = dO[g][t]
        mma_3xtf32(dpt[n], dpt_small[n], a_big, a_small, op[0], op[4]);
      }
    }

    // P^T and dS^T in place of S^T and dP^T
    const bool diag = causal && i * kQ < (kt + 1) * kTile;  // tiles the diagonal crosses
#pragma unroll
    for (int n = 0; n < kQ / 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * n + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(delta_s + 8 * n + 2 * t);
      const float lq[2] = {l2.x, l2.y}, dl[2] = {d2.x, d2.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int query = i * kQ + 8 * n + 2 * t + (e & 1);
        const float s = st[n][e] + st_small[n][e];
        const float p = (diag && query < key + 8 * (e >> 1)) ? 0.f : expf(s - lq[e & 1]);
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] + dpt_small[n][e] - dl[e & 1]) * scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q (see above)
#pragma unroll
    for (int h = 0; h < D / 64; ++h) {
      add_rows_product<D, kQ>(dv_acc, st, do_s, h, g, t);
      add_rows_product<D, kQ>(dk_acc, dpt, q_s, h, g, t);
    }
  }

  float* dk0 = dk + koff + static_cast<size_t>(row) * D + 2 * t;
  float* dv0 = dv + koff + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<float2*>(dk0 + 8 * n) = make_float2(dk_acc[n][0], dk_acc[n][1]);
    *reinterpret_cast<float2*>(dk0 + 8 * D + 8 * n) = make_float2(dk_acc[n][2], dk_acc[n][3]);
    *reinterpret_cast<float2*>(dv0 + 8 * n) = make_float2(dv_acc[n][0], dv_acc[n][1]);
    *reinterpret_cast<float2*>(dv0 + 8 * D + 8 * n) = make_float2(dv_acc[n][2], dv_acc[n][3]);
  }
}

// ---------------------------------------------------------------------------
// f32 dQ on the tensor cores: 3xTF32 with mma.sync m16n8k8
//
// Replaces TPU kernels K2d and K2f in f32, `_dq_kernel`
// (pytorch_distributed_training_tpu/ops/flash_attention.py:233) and
// `_dq_stream_kernel` (:460), and the tiled FFMA dQ before it, which
// reached 40% of the 67 TFLOP/s of the CUDA cores (3.83 ms against an FFMA
// bound of 1.54 ms at [8, 16, 2048, 64] causal on the H100): only the
// tensor cores can go below that. Bound: flash_flops(part="dq"), three
// products over the kept (query, key) pairs, at 164.9 TFLOP/s (3xTF32, see
// the forward above): 0.625 ms at that shape. Every product is taken in
// 3xTF32 as in the forward, with the same split, rounding and fragment
// loads.
//
// The forward's loop with one more product. A block of 4 warps owns a
// 64-row Q tile, 16 rows a warp (longest rows first, as the forward), and
// streams K/V tiles of kKeys = 32 rows:
// - S = (scale Q) K^T and dP = dO V^T: A is the warp's 16 rows of Q (times
//   scale, which changes only the rounding order against the JAX kernel's
//   scale (q . k)) or of dO, split once, before the loop, into big and
//   small shared-memory planes with rows of D + 4 floats; B[t][g] is K[g][t]
//   (V[g][t]), read from the streamed tile as the forward reads K, and split
//   per warp. Each lane keeps the lse and delta of its two rows in
//   registers.
// - P = exp(S - lse) and dS = P (dP - delta) scale stay in the registers of
//   S's and dP's C fragments; the mask (p = 0 where query < key, as
//   exp(-1e30 - lse) is) only on the K tiles the diagonal crosses.
// - dQ += dS K contracts over the tile's keys: the step takes key 2t as
//   k = t and key 2t + 1 as k = t + 4, so A is {c0, c2, c1, c3} of dS's
//   fragment as it stands, and B is K[2t][g], K[2t + 1][g], read as the
//   forward reads V (add_rows_product).
// K and V tiles stream through the forward's 2-stage cp.async ring: one
// commit group and one barrier a tile, the copy of tile j + 1 issued after
// the barrier that ends every warp's use of its stage. Shared memory: the
// four Q/dO planes (68 KB at D = 64, 132 KB at D = 128) and the ring (34
// KB, 66 KB): two blocks an SM at D = 64, one at D = 128 (the forward's
// 64-key tiles at D = 128 would not fit beside the planes).
// A dQ row sums over up to S / kKeys tiles (1024 at S = 32768), and the
// tensor cores add their products by truncation (the forward's o drifted
// to 5.4e-5 with one chain across all tiles), so each tile's dS K starts
// from zero, 64 columns at a time, with the small products in an
// accumulator of their own, and is added to the running dQ in f32. No
// atomics: the block owns its query rows, so dq repeats bit for bit.

template <int D>
struct Dq3xLayout {
  static constexpr int kKeys = 32;            // K/V rows a streamed tile
  static constexpr int kLd = D + 4;           // floats a staged row
  static constexpr int kPlane = kTile * kLd;  // a Q or dO plane
  static constexpr int kKvFloats = kKeys * kLd;
  // Q big, Q small, dO big, dO small, then 2 stages of K and V
  static constexpr int kBytes = (4 * kPlane + 4 * kKvFloats) * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads3x, D == 64 ? 2 : 1)
flash_bwd_dq_3xtf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dq, int seq, float scale, int causal) {
  using L = Dq3xLayout<D>;
  constexpr int kLd = L::kLd, kKeys = L::kKeys;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_big = reinterpret_cast<float*>(smem_raw);  // [kTile][kLd] each
  float* q_small = q_big + L::kPlane;
  float* do_big = q_small + L::kPlane;
  float* do_small = do_big + L::kPlane;
  float* ring = do_small + L::kPlane;  // [stage][K, V][kKeys][kLd]
  const int qt = seq / kTile - 1 - static_cast<int>(blockIdx.x);  // longest rows first
  const size_t head = static_cast<size_t>(blockIdx.y) * seq * D;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int row = warp * 16 + g;  // this lane's first row in the tile; the second is row + 8
  const int q_row = qt * kTile + row;
  // the last K/V tile: causal, the one that holds the tile's last row
  const int last = causal ? ((qt + 1) * kTile - 1) / kKeys : seq / kKeys - 1;

  auto stage_kv = [&](int j) {
    float* dst = ring + (j & 1) * 2 * L::kKvFloats;
    const size_t off = head + static_cast<size_t>(j) * kKeys * D;
    stage_f32<kKeys, D>(dst, k + off);
    stage_f32<kKeys, D>(dst + L::kKvFloats, v + off);
    cp_async_commit();
  };
  stage_kv(0);

  // q * scale and dO split into their planes; the loop's first barrier
  // publishes them
  const size_t qoff = head + static_cast<size_t>(qt) * kTile * D;
#pragma unroll
  for (int i = 0; i < kTile * D / 4 / kThreads3x; ++i) {
    const int c = threadIdx.x + i * kThreads3x;
    const int r = c / (D / 4), col = (c % (D / 4)) * 4;
    const float4 xq = ld4(q + qoff + static_cast<size_t>(r) * D + col);
    const float4 xd = ld4(dout + qoff + static_cast<size_t>(r) * D + col);
    const float qs[4] = {xq.x * scale, xq.y * scale, xq.z * scale, xq.w * scale};
    const float dos[4] = {xd.x, xd.y, xd.z, xd.w};
    uint32_t qb[4], qsm[4], db[4], dsm[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      split_tf32(qs[e], qb[e], qsm[e]);
      split_tf32(dos[e], db[e], dsm[e]);
    }
    const int at = r * kLd + col;
    *reinterpret_cast<uint4*>(q_big + at) = make_uint4(qb[0], qb[1], qb[2], qb[3]);
    *reinterpret_cast<uint4*>(q_small + at) = make_uint4(qsm[0], qsm[1], qsm[2], qsm[3]);
    *reinterpret_cast<uint4*>(do_big + at) = make_uint4(db[0], db[1], db[2], db[3]);
    *reinterpret_cast<uint4*>(do_small + at) = make_uint4(dsm[0], dsm[1], dsm[2], dsm[3]);
  }
  const float* lse_r = lse + static_cast<size_t>(blockIdx.y) * seq + q_row;
  const float* delta_r = delta + static_cast<size_t>(blockIdx.y) * seq + q_row;
  const float l0 = lse_r[0], l1 = lse_r[8], de0 = delta_r[0], de1 = delta_r[8];

  float dq_acc[D / 8][4] = {};  // the running dQ: rows row, row + 8; columns 8 n + 2 t, + 1
  for (int j = 0; j <= last; ++j) {
    cp_async_wait_all();  // this thread's copies of tile j
    __syncthreads();      // everyone's; and every warp is done with tile j - 1
    if (j < last) stage_kv(j + 1);
    const float* k_s = ring + (j & 1) * 2 * L::kKvFloats;
    const float* v_s = k_s + L::kKvFloats;

    // S = (scale Q) K^T and dP = dO V^T: rows row, row + 8; keys 8 n + 2 t, + 1
    float s[kKeys / 8][4] = {}, s_small[kKeys / 8][4] = {};
    float dp[kKeys / 8][4] = {}, dp_small[kKeys / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int at = row * kLd + 8 * kk + t;
      const int offs[4] = {at, at + 8 * kLd, at + 4, at + 8 * kLd + 4};
      uint32_t a_big[4], a_small[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a_big[e] = __float_as_uint(q_big[offs[e]]);
        a_small[e] = __float_as_uint(q_small[offs[e]]);
      }
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
        const float* kp = k_s + (8 * n + g) * kLd + 8 * kk + t;  // B[t][g] = K[g][t]
        mma_3xtf32(s[n], s_small[n], a_big, a_small, kp[0], kp[4]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a_big[e] = __float_as_uint(do_big[offs[e]]);
        a_small[e] = __float_as_uint(do_small[offs[e]]);
      }
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
        const float* vp = v_s + (8 * n + g) * kLd + 8 * kk + t;  // B[t][g] = V[g][t]
        mma_3xtf32(dp[n], dp_small[n], a_big, a_small, vp[0], vp[4]);
      }
    }

    // dS in place of S
    const bool diag = causal && (j + 1) * kKeys > qt * kTile;  // tiles the diagonal crosses
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * kKeys + 8 * n + 2 * t + (e & 1);
        const bool low = e < 2;
        const float p = (diag && key > q_row + (low ? 0 : 8))
                            ? 0.f
                            : expf(s[n][e] + s_small[n][e] - (low ? l0 : l1));
        s[n][e] = p * (dp[n][e] + dp_small[n][e] - (low ? de0 : de1)) * scale;
      }
    }

    // dQ += dS K (see above)
#pragma unroll
    for (int h = 0; h < D / 64; ++h) add_rows_product<D, kKeys>(dq_acc, s, k_s, h, g, t);
  }

  float* dq0 = dq + qoff + static_cast<size_t>(row) * D + 2 * t;
  float* dq1 = dq0 + 8 * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<float2*>(dq0 + 8 * n) = make_float2(dq_acc[n][0], dq_acc[n][1]);
    *reinterpret_cast<float2*>(dq1 + 8 * n) = make_float2(dq_acc[n][2], dq_acc[n][3]);
  }
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
  return launch(flash_fwd_3xtf32_kernel<D>, kThreads3x, Fwd3xLayout<D>::kBytes, seq, bh, st,
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
  return launch(flash_bwd_dkv_3xtf32_kernel<D>, kThreads3x, Dkv3xLayout<D>::kBytes, seq, bh, st,
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
  return launch(flash_bwd_dq_3xtf32_kernel<D>, kThreads3x, Dq3xLayout<D>::kBytes, seq, bh, st,
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
