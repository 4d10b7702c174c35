// Flash attention, forward and backward, written by hand for Hopper
// (sm_90a), with a plain C interface that the Python side binds with ctypes
// (pytorch_distributed_training_tpu_torch/kernels/__init__.py).
//
// q, k, v, o, dO, dq, dk, dv are [BH, S, D] (heads folded into the batch),
// lse and delta are [BH, S] f32. D is 64 or 128; S is a multiple of 64.
//
// flash_fwd replaces the TPU kernel `_fwd_kernel`
// (pytorch_distributed_training_tpu/ops/flash_attention.py:178, launched at
// :651): online softmax over K/V tiles with f32 accumulation, o in the input
// dtype and lse = m + log(l) in f32. With `causal` the loop over K tiles
// stops at the diagonal tile (:190-194); masked scores are -1e30, not -inf
// (:48-50, :68).
//
// flash_bwd replaces the fused backward `_dqkv_kernel` (:278, launched at
// :775). The TPU kernel carries dK/dV in VMEM across a sequential grid
// dimension (:296-300, "arbitrary" at :781); blocks on this card run in no
// order, so the backward is two launches, each deterministic: a dK/dV
// kernel that owns a K tile and loops over Q tiles, and a dQ kernel that
// owns a Q tile and loops over K tiles. Both recompute p = exp(s - lse);
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
//   in the forward (:188), scale * (q . k) in the backward (:319).
//
// Bound: operations. At the LM's shape (BH 128, S 2048, D 64, causal) the
// forward does 2 S^2 D BH flops over the causal half (68.7 GFLOP: 0.069 ms
// at 989 TFLOP/s bf16) against 100 MB of traffic (0.03 ms at 3.35 TB/s);
// the backward's five products are 171.8 GFLOP. Design: a block owns one
// 64-row tile (4 warps x 16 rows, one m16 fragment row each); K/V (or Q/dO)
// tiles are staged in shared memory, rows padded by 8 elements so that the
// fragment loads hit 32 distinct banks; s and p never leave registers: the
// m16n8 accumulator layout of S is the A-fragment layout of the next
// product, so p (and ds) feed the tensor cores straight from registers.
// Operands that the next product needs with the other axis contiguous are
// staged transposed. This is the simple version: no cp.async/TMA pipelining
// and no wgmma; the f32 path is one warp per row.

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
constexpr int kRowsF32 = 4;     // f32 path: one warp per row, 4 rows a block

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
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
// f32: one warp per row, lane i holding elements i, i + 32, ... of it

template <int D>
__global__ void __launch_bounds__(kRowsF32 * 32)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int seq, float scale, int causal) {
  constexpr int P = D / 32;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsF32 + (threadIdx.x >> 5);
  const size_t head = static_cast<size_t>(blockIdx.y) * seq * D;
  float qv[P], acc[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    qv[i] = q[head + static_cast<size_t>(row) * D + lane + 32 * i] * scale;
    acc[i] = 0.f;
  }
  float m = kNeg, l = 0.f;
  const int last = causal ? row : seq - 1;
  for (int key = 0; key <= last; ++key) {
    const float* kr = k + head + static_cast<size_t>(key) * D;
    const float* vr = v + head + static_cast<size_t>(key) * D;
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) part = fmaf(qv[i], kr[lane + 32 * i], part);
    const float sv = warp_sum(part);
    const float mx = fmaxf(m, sv);
    const float a = expf(m - mx);
    const float p = expf(sv - mx);
    l = a * l + p;
    m = mx;
#pragma unroll
    for (int i = 0; i < P; ++i) acc[i] = acc[i] * a + p * vr[lane + 32 * i];
  }
#pragma unroll
  for (int i = 0; i < P; ++i) o[head + static_cast<size_t>(row) * D + lane + 32 * i] = acc[i] / l;
  if (lane == 0) lse[static_cast<size_t>(blockIdx.y) * seq + row] = m + logf(l);
}

template <int D>
__global__ void __launch_bounds__(kRowsF32 * 32)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int seq,
                         float scale, int causal) {
  constexpr int P = D / 32;
  const int lane = threadIdx.x & 31;
  const int key = blockIdx.x * kRowsF32 + (threadIdx.x >> 5);
  const size_t head = static_cast<size_t>(blockIdx.y) * seq * D;
  const float* lse_h = lse + static_cast<size_t>(blockIdx.y) * seq;
  const float* delta_h = delta + static_cast<size_t>(blockIdx.y) * seq;
  float kv[P], vv[P], dka[P], dva[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    kv[i] = k[head + static_cast<size_t>(key) * D + lane + 32 * i];
    vv[i] = v[head + static_cast<size_t>(key) * D + lane + 32 * i];
    dka[i] = dva[i] = 0.f;
  }
  for (int qi = causal ? key : 0; qi < seq; ++qi) {
    const float* qr = q + head + static_cast<size_t>(qi) * D;
    const float* dr = dout + head + static_cast<size_t>(qi) * D;
    float qv[P], dov[P];
    float sp = 0.f, dpp = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      qv[i] = qr[lane + 32 * i];
      dov[i] = dr[lane + 32 * i];
      sp = fmaf(qv[i], kv[i], sp);
      dpp = fmaf(dov[i], vv[i], dpp);
    }
    const float p = expf(scale * warp_sum(sp) - lse_h[qi]);
    const float ds = p * (warp_sum(dpp) - delta_h[qi]) * scale;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      dva[i] = fmaf(p, dov[i], dva[i]);
      dka[i] = fmaf(ds, qv[i], dka[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
    dk[head + static_cast<size_t>(key) * D + lane + 32 * i] = dka[i];
    dv[head + static_cast<size_t>(key) * D + lane + 32 * i] = dva[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kRowsF32 * 32)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int seq, float scale, int causal) {
  constexpr int P = D / 32;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsF32 + (threadIdx.x >> 5);
  const size_t head = static_cast<size_t>(blockIdx.y) * seq * D;
  const float l = lse[static_cast<size_t>(blockIdx.y) * seq + row];
  const float de = delta[static_cast<size_t>(blockIdx.y) * seq + row];
  float qv[P], dov[P], dqa[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    qv[i] = q[head + static_cast<size_t>(row) * D + lane + 32 * i];
    dov[i] = dout[head + static_cast<size_t>(row) * D + lane + 32 * i];
    dqa[i] = 0.f;
  }
  const int last = causal ? row : seq - 1;
  for (int key = 0; key <= last; ++key) {
    const float* kr = k + head + static_cast<size_t>(key) * D;
    const float* vr = v + head + static_cast<size_t>(key) * D;
    float kv[P];
    float sp = 0.f, dpp = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      kv[i] = kr[lane + 32 * i];
      sp = fmaf(qv[i], kv[i], sp);
      dpp = fmaf(dov[i], vr[lane + 32 * i], dpp);
    }
    const float p = expf(scale * warp_sum(sp) - l);
    const float ds = p * (warp_sum(dpp) - de) * scale;
#pragma unroll
    for (int i = 0; i < P; ++i) dqa[i] = fmaf(ds, kv[i], dqa[i]);
  }
#pragma unroll
  for (int i = 0; i < P; ++i) dq[head + static_cast<size_t>(row) * D + lane + 32 * i] = dqa[i];
}

// ---------------------------------------------------------------------------
// launchers

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
        int seq, float scale, int causal, int dtype, cudaStream_t st) {
  float* l = static_cast<float*>(lse);
  if (dtype == kBF16) {
    constexpr int smem = fwd_smem_bytes<D>();
    cudaError_t err = set_smem(flash_fwd_bf16_kernel<D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_bf16_kernel<D><<<dim3(seq / kTile, bh), kThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), l, seq, scale, causal);
  } else {
    flash_fwd_f32_kernel<D><<<dim3(seq / kRowsF32, bh), kRowsF32 * 32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), l, seq, scale, causal);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* delta, void* dq, void* dk, void* dv, int bh, int seq, float scale,
        int causal, int dtype, cudaStream_t st) {
  const float* l = static_cast<const float*>(lse);
  const float* de = static_cast<const float*>(delta);
  if (dtype == kBF16) {
    const bf16* qb = static_cast<const bf16*>(q);
    const bf16* kb = static_cast<const bf16*>(k);
    const bf16* vb = static_cast<const bf16*>(v);
    const bf16* db = static_cast<const bf16*>(dout);
    constexpr int smem_kv = dkv_smem_bytes<D>();
    cudaError_t err = set_smem(flash_bwd_dkv_bf16_kernel<D>, smem_kv);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dkv_bf16_kernel<D><<<dim3(seq / kTile, bh), kThreads, smem_kv, st>>>(
        qb, kb, vb, db, l, de, static_cast<bf16*>(dk), static_cast<bf16*>(dv), seq,
        scale, causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    constexpr int smem_q = dq_smem_bytes<D>();
    err = set_smem(flash_bwd_dq_bf16_kernel<D>, smem_q);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dq_bf16_kernel<D><<<dim3(seq / kTile, bh), kThreads, smem_q, st>>>(
        qb, kb, vb, db, l, de, static_cast<bf16*>(dq), seq, scale, causal);
  } else {
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    const float* df = static_cast<const float*>(dout);
    const dim3 grid(seq / kRowsF32, bh);
    flash_bwd_dkv_f32_kernel<D><<<grid, kRowsF32 * 32, 0, st>>>(
        qf, kf, vf, df, l, de, static_cast<float*>(dk), static_cast<float*>(dv), seq,
        scale, causal);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dq_f32_kernel<D><<<grid, kRowsF32 * 32, 0, st>>>(
        qf, kf, vf, df, l, de, static_cast<float*>(dq), seq, scale, causal);
  }
  return static_cast<int>(cudaGetLastError());
}

bool shapes_ok(int bh, int seq, int head_dim, int dtype) {
  return bh > 0 && bh <= 65535 && seq > 0 && seq % kTile == 0 &&
         (head_dim == 64 || head_dim == 128) && (dtype == kF32 || dtype == kBF16);
}

}  // namespace

// Each entry point launches on `stream`, does not synchronise, allocates
// nothing, and returns cudaGetLastError() (0 when every launch was
// accepted). Arguments the kernels do not take return cudaErrorInvalidValue
// unlaunched. flash_bwd launches two kernels: dK/dV, then dQ.

extern "C" int pdt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, int bh, int seq, int head_dim, float scale,
                             int causal, int dtype, void* stream) {
  if (!shapes_ok(bh, seq, head_dim, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return fwd<64>(q, k, v, o, lse, bh, seq, scale, causal, dtype, st);
  return fwd<128>(q, k, v, o, lse, bh, seq, scale, causal, dtype, st);
}

extern "C" int pdt_flash_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta,
                             void* dq, void* dk, void* dv, int bh, int seq, int head_dim,
                             float scale, int causal, int dtype, void* stream) {
  if (!shapes_ok(bh, seq, head_dim, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    return bwd<64>(q, k, v, dout, lse, delta, dq, dk, dv, bh, seq, scale, causal, dtype, st);
  }
  return bwd<128>(q, k, v, dout, lse, delta, dq, dk, dv, bh, seq, scale, causal, dtype, st);
}
