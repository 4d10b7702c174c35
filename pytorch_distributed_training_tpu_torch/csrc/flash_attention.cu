// Flash attention, forward and backward, written by hand for Hopper
// (sm_90a), with a plain C interface that the Python side binds with ctypes
// (pytorch_distributed_training_tpu_torch/kernels/__init__.py).
//
// q, k, v, o, dO, dq, dk, dv are [BH, S, D] (heads folded into the batch),
// lse and delta are [BH, S] f32. D is 64 or 128; S is a multiple of 64.
//
// The forward (pdt_flash_fwd) stands in for both TPU forwards, `_fwd_kernel`
// (pytorch_distributed_training_tpu/ops/flash_attention.py:178, launched at
// :651), which holds the whole K/V rows in VMEM, and `_fwd_stream_kernel`
// (:407, launched at :615), which streams K/V tiles once 2 S D 4 bytes pass
// the 8 MiB VMEM budget (:114-120). Here K/V always stream through shared
// memory one 64-row tile at a time, so one kernel covers every S: online
// softmax with f32 accumulation, o in the input dtype and lse = m + log(l)
// in f32. With `causal` the loop over K tiles stops at the diagonal tile
// (:190-194); masked scores are -1e30, not -inf (:48-50, :68).
//
// The backward is two launches, each deterministic: a dK/dV kernel
// (pdt_flash_bwd_dkv) that owns a K tile and loops over Q tiles, and a dQ
// kernel (pdt_flash_bwd_dq) that owns a Q tile and loops over K tiles. That
// is the TPU's split backward, `_dkv_kernel` (:348) / `_dq_kernel` (:233)
// for resident shapes and `_dkv_stream_kernel` (:506) / `_dq_stream_kernel`
// (:460) for streamed ones; the pair also stands in for the fused
// `_dqkv_kernel` (:278, launched at :775), which carries dK/dV in VMEM
// across a sequential grid dimension (:296-300, "arbitrary" at :781):
// blocks on this card run in no order. Both recompute p = exp(s - lse);
// delta = rowsum(dO * O) comes from outside, as in the JAX package
// (:761-764). dK/dV accumulate in f32 and are rounded once when written
// (:802); dq is written in q's dtype.
//
// Numerics, as in the JAX kernels:
// - bf16 inputs: bf16 operands into the tensor cores (mma.sync m16n8k16)
//   with f32 accumulation; the scale multiplies s after the dot (:206-207);
//   p is rounded to bf16 before PV and before dV (:216, :327); ds is rounded
//   to bf16 before dK and dQ (:335).
// - f32 inputs: f32 FMA on the CUDA cores, no TF32; q * scale before the dot
//   in the forward (:188), scale * (q . k) in the backward (:256, :319).
//
// Bound: operations. At the LM's shape (BH 128, S 2048, D 64, causal) the
// forward does 2 S^2 D BH flops over the causal half (68.7 GFLOP: 0.069 ms
// at 989 TFLOP/s bf16) against 100 MB of traffic (0.03 ms at 3.35 TB/s);
// the backward's five products are 171.8 GFLOP. In f32 the same work runs
// at most at 67 TFLOP/s. bf16 design: a block owns one 64-row tile (4 warps
// x 16 rows, one m16 fragment row each); K/V (or Q/dO) tiles are staged in
// shared memory, rows padded by 8 elements so that the fragment loads hit
// 32 distinct banks; s and p never leave registers: the m16n8 accumulator
// layout of S is the A-fragment layout of the next product, so p (and ds)
// feed the tensor cores straight from registers. Operands that the next
// product needs with the other axis contiguous are staged transposed. f32
// design: see the f32 section. This is the simple version: no cp.async/TMA
// pipelining and no wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum DType : int { kF32 = 0, kBF16 = 1 };

typedef __nv_bfloat16 bf16;

constexpr float kNeg = -1e30f;  // finite mask value (flash_attention.py:68)
constexpr int kTile = 64;       // query rows / key rows per tile
constexpr int kThreads = 128;   // 4 warps x 16 rows

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (rows r0..r0+15, cols k0..k0+15) of a row-major tile
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* src, int ld, int r0,
                                       int k0, int g, int t) {
  a[0] = ld32(src + (r0 + g) * ld + k0 + 2 * t);
  a[1] = ld32(src + (r0 + g + 8) * ld + k0 + 2 * t);
  a[2] = ld32(src + (r0 + g) * ld + k0 + 2 * t + 8);
  a[3] = ld32(src + (r0 + g + 8) * ld + k0 + 2 * t + 8);
}

// B fragment (k0..k0+15 x n0..n0+7) of a tile stored [n][k], k contiguous
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1, const bf16* src,
                                       int ld, int n0, int k0, int g, int t) {
  b0 = ld32(src + (n0 + g) * ld + k0 + 2 * t);
  b1 = ld32(src + (n0 + g) * ld + k0 + 2 * t + 8);
}

// A fragment for k-block kk from 16x8 accumulators: the m16n8 C layout of
// tiles 2kk and 2kk+1 is the m16k16 A layout, so no shuffle is needed
__device__ __forceinline__ void acc_to_a(uint32_t* a, float (*acc)[4], int kk) {
  a[0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
  a[1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
  a[2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
  a[3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
}

// a [kTile, D] tile of a row-major [S, D] matrix into shared memory
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src) {
  constexpr int kChunks = kTile * D / 8;
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + col) =
        *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * D + col);
  }
}

// the same tile transposed: dst[col][row]
template <int D>
__device__ __forceinline__ void load_tile_t(bf16* dst, int ld, const bf16* src) {
  constexpr int kChunks = kTile * D / 8;
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    const uint4 v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * D + col);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(col + i) * ld + r] = e[i];
  }
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
// bf16: tensor-core kernels

template <int D>
constexpr int fwd_smem_bytes() {
  return (2 * kTile * (D + 8) + D * (kTile + 8)) * 2;
}
template <int D>
constexpr int dkv_smem_bytes() {
  return (4 * kTile * (D + 8) + 2 * D * (kTile + 8)) * 2 + 2 * kTile * 4;
}
template <int D>
constexpr int dq_smem_bytes() {
  return (4 * kTile * (D + 8) + D * (kTile + 8)) * 2;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int seq, float scale, int causal) {
  constexpr int LD = D + 8;
  constexpr int LDT = kTile + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kTile][LD]
  bf16* k_s = q_s + kTile * LD;                   // [kTile][LD]
  bf16* vt_s = k_s + kTile * LD;                  // [D][LDT]
  const int n_tiles = seq / kTile;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);  // longest rows first
  const size_t head = static_cast<size_t>(blockIdx.y) * seq * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;

  load_tile<D>(q_s, LD, q + head + static_cast<size_t>(qt) * kTile * D);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a(qf[kk], q_s, LD, r0, kk * 16, g, t);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  const int last = causal ? qt : n_tiles - 1;
  for (int j = 0; j <= last; ++j) {
    __syncthreads();  // the previous tile is consumed
    load_tile<D>(k_s, LD, k + head + static_cast<size_t>(j) * kTile * D);
    load_tile_t<D>(vt_s, LDT, v + head + static_cast<size_t>(j) * kTile * D);
    __syncthreads();
    float s[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, k_s, LD, n * 8, kk * 16, g, t);
        mma_bf16(s[n], qf[kk], b0, b1);
      }
    }
    const bool diag = causal && j == qt;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[n][e] * scale;
        if (diag) {
          const int row = r0 + g + (e >= 2 ? 8 : 0);
          const int col = n * 8 + 2 * t + (e & 1);
          if (col > row) val = kNeg;
        }
        s[n][e] = val;
        if (e < 2) mx0 = fmaxf(mx0, val); else mx1 = fmaxf(mx1, val);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float a0 = expf(m0 - mx0), a1 = expf(m1 - mx1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      s[n][0] = expf(s[n][0] - mx0);
      s[n][1] = expf(s[n][1] - mx0);
      s[n][2] = expf(s[n][2] - mx1);
      s[n][3] = expf(s[n][3] - mx1);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = a0 * l0 + quad_sum(ps0);
    l1 = a1 * l1 + quad_sum(ps1);
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s, kk);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, vt_s, LDT, n * 8, kk * 16, g, t);
        mma_bf16(acc[n], pa, b0, b1);
      }
    }
  }
  const int row = qt * kTile + r0 + g;
  bf16* o0 = o + head + static_cast<size_t>(row) * D;
  bf16* o1 = o0 + 8 * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(o0 + col) = pack_bf16(acc[n][0] / l0, acc[n][1] / l0);
    *reinterpret_cast<uint32_t*>(o1 + col) = pack_bf16(acc[n][2] / l1, acc[n][3] / l1);
  }
  if (t == 0) {
    float* lr = lse + static_cast<size_t>(blockIdx.y) * seq + row;
    lr[0] = m0 + logf(l0);
    lr[8] = m1 + logf(l1);
  }
}

// dK/dV: the block owns K tile kt (4 warps x 16 key rows) and loops over Q
// tiles; every product is computed transposed (rows = keys).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int seq,
                          float scale, int causal) {
  constexpr int LD = D + 8;
  constexpr int LDT = kTile + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [kTile][LD]
  bf16* v_s = k_s + kTile * LD;                   // [kTile][LD]
  bf16* q_s = v_s + kTile * LD;                   // [kTile][LD]
  bf16* do_s = q_s + kTile * LD;                  // [kTile][LD]
  bf16* qt_s = do_s + kTile * LD;                 // [D][LDT]
  bf16* dot_s = qt_s + D * LDT;                   // [D][LDT]
  float* lse_s = reinterpret_cast<float*>(dot_s + D * LDT);
  float* delta_s = lse_s + kTile;
  const int n_tiles = seq / kTile;
  const int kt = blockIdx.x;  // causal: low K tiles see the most Q tiles
  const size_t head = static_cast<size_t>(blockIdx.y) * seq * D;
  const float* lse_h = lse + static_cast<size_t>(blockIdx.y) * seq;
  const float* delta_h = delta + static_cast<size_t>(blockIdx.y) * seq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;

  load_tile<D>(k_s, LD, k + head + static_cast<size_t>(kt) * kTile * D);
  load_tile<D>(v_s, LD, v + head + static_cast<size_t>(kt) * kTile * D);
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dk_acc[n][0] = dk_acc[n][1] = dk_acc[n][2] = dk_acc[n][3] = 0.f;
    dv_acc[n][0] = dv_acc[n][1] = dv_acc[n][2] = dv_acc[n][3] = 0.f;
  }
  for (int qi = causal ? kt : 0; qi < n_tiles; ++qi) {
    __syncthreads();
    const size_t off = head + static_cast<size_t>(qi) * kTile * D;
    load_tile<D>(q_s, LD, q + off);
    load_tile_t<D>(qt_s, LDT, q + off);
    load_tile<D>(do_s, LD, dout + off);
    load_tile_t<D>(dot_s, LDT, dout + off);
    if (threadIdx.x < kTile) {
      lse_s[threadIdx.x] = lse_h[qi * kTile + threadIdx.x];
      delta_s[threadIdx.x] = delta_h[qi * kTile + threadIdx.x];
    }
    __syncthreads();
    // s^T = K Q^T
    float st[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a(a, k_s, LD, r0, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, q_s, LD, n * 8, kk * 16, g, t);
        mma_bf16(st[n], a, b0, b1);
      }
    }
    // p^T = exp(scale s^T - lse), 0 above the diagonal
    const bool diag = causal && qi == kt;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = r0 + g + (e >= 2 ? 8 : 0);
        const int qrow = n * 8 + 2 * t + (e & 1);
        st[n][e] = (diag && qrow < key) ? 0.f : expf(scale * st[n][e] - lse_s[qrow]);
      }
    }
    // dV += bf16(p)^T dO
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, st, kk);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, dot_s, LDT, n * 8, kk * 16, g, t);
        mma_bf16(dv_acc[n], pa, b0, b1);
      }
    }
    // dp^T = V dO^T
    float dpt[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a(a, v_s, LD, r0, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, do_s, LD, n * 8, kk * 16, g, t);
        mma_bf16(dpt[n], a, b0, b1);
      }
    }
    // ds^T = p^T (dp^T - delta) scale, kept in st
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qrow = n * 8 + 2 * t + (e & 1);
        st[n][e] = st[n][e] * (dpt[n][e] - delta_s[qrow]) * scale;
      }
    }
    // dK += bf16(ds)^T Q
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t da[4];
      acc_to_a(da, st, kk);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, qt_s, LDT, n * 8, kk * 16, g, t);
        mma_bf16(dk_acc[n], da, b0, b1);
      }
    }
  }
  const size_t row0 = head + static_cast<size_t>(kt * kTile + r0 + g) * D;
  const size_t row1 = row0 + 8 * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(dk + row0 + col) = pack_bf16(dk_acc[n][0], dk_acc[n][1]);
    *reinterpret_cast<uint32_t*>(dk + row1 + col) = pack_bf16(dk_acc[n][2], dk_acc[n][3]);
    *reinterpret_cast<uint32_t*>(dv + row0 + col) = pack_bf16(dv_acc[n][0], dv_acc[n][1]);
    *reinterpret_cast<uint32_t*>(dv + row1 + col) = pack_bf16(dv_acc[n][2], dv_acc[n][3]);
  }
}

// dQ: the block owns Q tile qt and loops over K tiles up to the diagonal.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, int seq, float scale, int causal) {
  constexpr int LD = D + 8;
  constexpr int LDT = kTile + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kTile][LD]
  bf16* do_s = q_s + kTile * LD;                  // [kTile][LD]
  bf16* k_s = do_s + kTile * LD;                  // [kTile][LD]
  bf16* v_s = k_s + kTile * LD;                   // [kTile][LD]
  bf16* kt_s = v_s + kTile * LD;                  // [D][LDT]
  const int n_tiles = seq / kTile;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);
  const size_t head = static_cast<size_t>(blockIdx.y) * seq * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const int row = qt * kTile + r0 + g;

  load_tile<D>(q_s, LD, q + head + static_cast<size_t>(qt) * kTile * D);
  load_tile<D>(do_s, LD, dout + head + static_cast<size_t>(qt) * kTile * D);
  __syncthreads();
  uint32_t qf[D / 16][4], df[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a(qf[kk], q_s, LD, r0, kk * 16, g, t);
    load_a(df[kk], do_s, LD, r0, kk * 16, g, t);
  }
  const float* lse_h = lse + static_cast<size_t>(blockIdx.y) * seq;
  const float* delta_h = delta + static_cast<size_t>(blockIdx.y) * seq;
  const float l0 = lse_h[row], l1 = lse_h[row + 8];
  const float de0 = delta_h[row], de1 = delta_h[row + 8];
  float dq_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;
  const int last = causal ? qt : n_tiles - 1;
  for (int j = 0; j <= last; ++j) {
    __syncthreads();
    const size_t off = head + static_cast<size_t>(j) * kTile * D;
    load_tile<D>(k_s, LD, k + off);
    load_tile_t<D>(kt_s, LDT, k + off);
    load_tile<D>(v_s, LD, v + off);
    __syncthreads();
    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, k_s, LD, n * 8, kk * 16, g, t);
        mma_bf16(s[n], qf[kk], b0, b1);
        load_b(b0, b1, v_s, LD, n * 8, kk * 16, g, t);
        mma_bf16(dp[n], df[kk], b0, b1);
      }
    }
    const bool diag = causal && j == qt;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qrow = r0 + g + (e >= 2 ? 8 : 0);
        const int key = n * 8 + 2 * t + (e & 1);
        const float l = e >= 2 ? l1 : l0;
        const float de = e >= 2 ? de1 : de0;
        const float p = (diag && key > qrow) ? 0.f : expf(scale * s[n][e] - l);
        s[n][e] = p * (dp[n][e] - de) * scale;
      }
    }
    // dQ += bf16(ds) K
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t da[4];
      acc_to_a(da, s, kk);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, kt_s, LDT, n * 8, kk * 16, g, t);
        mma_bf16(dq_acc[n], da, b0, b1);
      }
    }
  }
  bf16* d0 = dq + head + static_cast<size_t>(row) * D;
  bf16* d1 = d0 + 8 * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(d0 + col) = pack_bf16(dq_acc[n][0], dq_acc[n][1]);
    *reinterpret_cast<uint32_t*>(d1 + col) = pack_bf16(dq_acc[n][2], dq_acc[n][3]);
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

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int seq,
        float scale, int causal, int dtype, cudaStream_t st) {
  float* l = static_cast<float*>(lse);
  if (dtype == kBF16) {
    return launch(flash_fwd_bf16_kernel<D>, kThreads, fwd_smem_bytes<D>(), seq, bh, st,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<bf16*>(o), l, seq, scale, causal);
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
    return launch(flash_bwd_dkv_bf16_kernel<D>, kThreads, dkv_smem_bytes<D>(), seq, bh, st,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l, de,
                  static_cast<bf16*>(dk), static_cast<bf16*>(dv), seq, scale, causal);
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
    return launch(flash_bwd_dq_bf16_kernel<D>, kThreads, dq_smem_bytes<D>(), seq, bh, st,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l, de,
                  static_cast<bf16*>(dq), seq, scale, causal);
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
