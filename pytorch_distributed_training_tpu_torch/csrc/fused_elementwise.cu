// Elementwise tails of the transformer block, written by hand for Hopper
// (sm_90a), with a plain C interface that the Python side binds with ctypes
// (pytorch_distributed_training_tpu_torch/kernels/__init__.py).
//
// add_layernorm replaces the TPU kernel `_add_ln_kernel`
// (pytorch_distributed_training_tpu/ops/fused_elementwise.py:88, launched at
// :107): s = round(x + delta) to the stream dtype, then LayerNorm of s with
// f32 statistics in flax's fast-variance form max(0, E[s^2] - E[s]^2), eps
// inside the rsqrt, then scale and bias; both s and y are written.
//
// bias_gelu replaces the TPU kernel `_bias_gelu_kernel` (same file, :203,
// launched at :214): y = gelu_erf(u + bias), exact-erf GELU, computed in f32
// and written in u's dtype.
//
// Bound: both are memory traffic. Each input element is read once and each
// output written once at the card's 3.35 TB/s; their arithmetic (a few f32
// operations and one erff per element) stays below that. HBM3 at ~0.7 us of
// latency needs ~2.3 MB in flight across the 132 SMs, ~18 KB an SM, so the
// design is bytes in flight: 16-byte accesses, each thread issuing all of
// its loads before it uses any, few long-lived blocks, no barrier on rows
// up to 1024 wide, and no shared memory, TMA or tensor cores.
//
// - add_layernorm, E <= 1024: one warp a row, 1-8 rows a block. At E = 1024
//   a lane loads 4 vectors of 8 elements of x and of delta, keeps the 32
//   rounded sums in registers, reduces sum and sum of squares with
//   __shfl_xor_sync only, and writes s and y with 16-byte stores.
//   1024 < E <= 8192: 256 threads a row, the same accesses and one
//   shared-memory exchange of the 8 warps' partial sums.
// - bias_gelu: a thread owns one 8-wide column vector: it loads its bias
//   once, then walks R rows (R = 8, 4, 2 or 1 from the row count, so that a
//   grid keeps 4 blocks an SM), issuing all R loads before it computes.
//   Where even R = 1 leaves fewer than 2 blocks an SM (decode's [8, 4096]),
//   a thread owns one element, on 8 times the blocks.
//   Its element loop issues ~33 instructions an element (one MUFU.EX2 in
//   erff; cuobjdump -sass, tools/elementwise_ab.py), so the issue rate
//   bounds it at ~82% of the byte bound at 1.98 GHz: it is bound by both.
// Ragged rows (E % 8 != 0) or any pointer not 16-byte aligned take the same
// kernels with scalar accesses (kWidth 1). On the TPU a grid step covered a
// 256-row tile held in VMEM; here blocks run in parallel and own whole rows.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

constexpr int kSms = 132;   // H100 SXM
constexpr int kVector = 8;  // elements a vector access moves

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// Eight elements of T as 32-bit words, moved with one (16-bit types) or two
// (f32) 16-byte accesses.
template <typename T>
struct Vec8 {
  static constexpr int kWords = sizeof(T) * kVector / 4;
  uint32_t w[kWords];
};

template <typename T>
__device__ __forceinline__ Vec8<T> load8(const T* p) {
  Vec8<T> v;
#pragma unroll
  for (int i = 0; i < Vec8<T>::kWords; i += 4) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + i / 4);
    v.w[i] = q.x, v.w[i + 1] = q.y, v.w[i + 2] = q.z, v.w[i + 3] = q.w;
  }
  return v;
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const Vec8<T>& v) {
#pragma unroll
  for (int i = 0; i < Vec8<T>::kWords; i += 4) {
    reinterpret_cast<uint4*>(p)[i / 4] = make_uint4(v.w[i], v.w[i + 1], v.w[i + 2], v.w[i + 3]);
  }
}

template <typename P>
__device__ __forceinline__ P as(uint32_t u) {
  P p;
  *reinterpret_cast<uint32_t*>(&p) = u;
  return p;
}
template <typename P>
__device__ __forceinline__ uint32_t bits(P p) {
  return *reinterpret_cast<const uint32_t*>(&p);
}

// unpack: 8 elements -> 8 floats; pack: 8 floats -> 8 elements, each
// rounded to nearest even on its own, as from_f32 does
__device__ __forceinline__ void unpack(const Vec8<float>& v, float* f) {
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __uint_as_float(v.w[i]);
}
__device__ __forceinline__ void unpack(const Vec8<__nv_bfloat16>& v, float* f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(as<__nv_bfloat162>(v.w[i]));
    f[2 * i] = p.x, f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ void unpack(const Vec8<__half>& v, float* f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __half22float2(as<__half2>(v.w[i]));
    f[2 * i] = p.x, f[2 * i + 1] = p.y;
  }
}

template <typename T>
__device__ __forceinline__ Vec8<T> pack(const float* f);
template <>
__device__ __forceinline__ Vec8<float> pack<float>(const float* f) {
  Vec8<float> v;
#pragma unroll
  for (int i = 0; i < 8; ++i) v.w[i] = __float_as_uint(f[i]);
  return v;
}
template <>
__device__ __forceinline__ Vec8<__nv_bfloat16> pack<__nv_bfloat16>(const float* f) {
  Vec8<__nv_bfloat16> v;
#pragma unroll
  for (int i = 0; i < 4; ++i) v.w[i] = bits(__floats2bfloat162_rn(f[2 * i], f[2 * i + 1]));
  return v;
}
template <>
__device__ __forceinline__ Vec8<__half> pack<__half>(const float* f) {
  Vec8<__half> v;
#pragma unroll
  for (int i = 0; i < 4; ++i) v.w[i] = bits(__floats2half2_rn(f[2 * i], f[2 * i + 1]));
  return v;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------------------
// residual add + LayerNorm

constexpr int kLnSlots = 32;                                 // row values a thread holds
constexpr int kLnWarpFeatures = 32 * kLnSlots;               // 1024: one warp a row
constexpr int kLnBlockThreads = 256;                         // threads a row above that
constexpr int kLnMaxFeatures = kLnBlockThreads * kLnSlots;  // 8192
constexpr int kLnMaxWarpsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

// kThreads 32: warp threadIdx.y owns row blockIdx.x * blockDim.y +
// threadIdx.y; kThreads 256: the block owns row blockIdx.x.  kWidth 8:
// vector accesses (E % 8 == 0, every pointer 16-byte aligned); 1: scalar.
template <typename T, typename U, int kThreads, int kWidth>
__global__ void __launch_bounds__(kLnBlockThreads)
add_layernorm_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, T* __restrict__ s_out,
                     U* __restrict__ y_out, int rows, int features, float eps) {
  constexpr int kIters = kLnSlots / kWidth;
  const int row = kThreads == 32 ? blockIdx.x * blockDim.y + threadIdx.y : blockIdx.x;
  if (row >= rows) return;  // a whole warp: no barrier in the warp kernel
  const int t = threadIdx.x;
  const int n = features / kWidth;  // vectors (or elements) in the row
  const size_t base = static_cast<size_t>(row) * features;
  // the row's rounded sum stays in registers: every loop is unrolled, so
  // every index into `vals` is a compile-time constant
  float vals[kLnSlots];
  float sum = 0.f;
  float sumsq = 0.f;
  if constexpr (kWidth == kVector) {
    Vec8<T> xv[kIters], dv[kIters];
#pragma unroll
    for (int k = 0; k < kIters; ++k) {  // every load before any use
      const int i = t + k * kThreads;
      if (i < n) {
        xv[k] = load8(x + base + kVector * i);
        dv[k] = load8(delta + base + kVector * i);
      }
    }
#pragma unroll
    for (int k = 0; k < kIters; ++k) {
      const int i = t + k * kThreads;
      float a[kVector], b[kVector];
      if (i < n) {
        unpack(xv[k], a);
        unpack(dv[k], b);
#pragma unroll
        for (int j = 0; j < kVector; ++j) a[j] += b[j];
        // the statistics read the ROUNDED sum, as the unfused LayerNorm would
        const Vec8<T> sv = pack<T>(a);
        store8(s_out + base + kVector * i, sv);
        unpack(sv, a);
      }
#pragma unroll
      for (int j = 0; j < kVector; ++j) {
        const float v = i < n ? a[j] : 0.f;
        vals[k * kVector + j] = v;
        sum += v;
        sumsq += v * v;
      }
    }
  } else {
    T xs[kIters], ds[kIters];
#pragma unroll
    for (int k = 0; k < kIters; ++k) {
      const int i = t + k * kThreads;
      if (i < n) {
        xs[k] = x[base + i];
        ds[k] = delta[base + i];
      }
    }
#pragma unroll
    for (int k = 0; k < kIters; ++k) {
      const int i = t + k * kThreads;
      vals[k] = 0.f;
      if (i < n) {
        const T s = from_f32<T>(to_f32(xs[k]) + to_f32(ds[k]));
        s_out[base + i] = s;
        const float v = to_f32(s);
        vals[k] = v;
        sum += v;
        sumsq += v * v;
      }
    }
  }
  sum = warp_sum(sum);
  sumsq = warp_sum(sumsq);
  if constexpr (kThreads > 32) {
    // the one exchange of a block row: every thread sums the warps'
    // partials in the same order, so no second barrier
    __shared__ float2 partial[kThreads / 32];
    if ((t & 31) == 0) partial[t >> 5] = make_float2(sum, sumsq);
    __syncthreads();
    sum = 0.f;
    sumsq = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      sum += partial[w].x;
      sumsq += partial[w].y;
    }
  }
  const float mu = sum / static_cast<float>(features);
  const float var = fmaxf(0.f, sumsq / static_cast<float>(features) - mu * mu);
  const float rstd = rsqrtf(var + eps);
  if constexpr (kWidth == kVector) {
#pragma unroll
    for (int k = 0; k < kIters; ++k) {
      const int i = t + k * kThreads;
      if (i < n) {
        const float4* sc = reinterpret_cast<const float4*>(scale + kVector * i);
        const float4* bi = reinterpret_cast<const float4*>(bias + kVector * i);
        const float4 s0 = __ldg(sc), s1 = __ldg(sc + 1), b0 = __ldg(bi), b1 = __ldg(bi + 1);
        const float g[kVector] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        const float h[kVector] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        float y[kVector];
#pragma unroll
        for (int j = 0; j < kVector; ++j) {
          const float xhat = (vals[k * kVector + j] - mu) * rstd;
          y[j] = xhat * g[j] + h[j];
        }
        store8(y_out + base + kVector * i, pack<U>(y));
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kIters; ++k) {
      const int i = t + k * kThreads;
      if (i < n) {
        const float xhat = (vals[k] - mu) * rstd;
        y_out[base + i] = from_f32<U>(xhat * scale[i] + bias[i]);
      }
    }
  }
}

template <typename T, typename U, int kWidth>
void launch_add_layernorm(const void* x, const void* delta, const float* scale,
                          const float* bias, void* s, void* y, int rows,
                          int features, float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(delta);
  if (features <= kLnWarpFeatures) {
    // 8 rows a block once the card holds a block an SM; fewer rows spread
    // over more SMs (decode's 8 rows: one warp on each of 8 SMs)
    int warps = rows / kSms;
    warps = warps < 1 ? 1 : (warps > kLnMaxWarpsPerBlock ? kLnMaxWarpsPerBlock : warps);
    add_layernorm_kernel<T, U, 32, kWidth><<<(rows + warps - 1) / warps, dim3(32, warps), 0,
                                             stream>>>(
        xt, dt, scale, bias, static_cast<T*>(s), static_cast<U*>(y), rows, features, eps);
  } else {
    add_layernorm_kernel<T, U, kLnBlockThreads, kWidth><<<rows, kLnBlockThreads, 0, stream>>>(
        xt, dt, scale, bias, static_cast<T*>(s), static_cast<U*>(y), rows, features, eps);
  }
}

template <typename T, typename U>
void dispatch_add_layernorm(const void* x, const void* delta, const float* scale,
                            const float* bias, void* s, void* y, int rows,
                            int features, float eps, cudaStream_t stream) {
  const bool vector = features % kVector == 0 && aligned16(x) && aligned16(delta) &&
                      aligned16(scale) && aligned16(bias) && aligned16(s) && aligned16(y);
  if (vector) {
    launch_add_layernorm<T, U, kVector>(x, delta, scale, bias, s, y, rows, features, eps, stream);
  } else {
    launch_add_layernorm<T, U, 1>(x, delta, scale, bias, s, y, rows, features, eps, stream);
  }
}

// ---------------------------------------------------------------------------
// bias + exact GELU: a thread owns one column vector (kWidth elements) and
// walks kRows rows of it at a time, grid-strided over row groups (grid y).

constexpr int kGeluThreads = 128;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float gelu_erf(float t) {
  return 0.5f * t * (1.f + erff(t * 0.70710678118654752f));
}

template <typename T, int kWidth, int kRows>
__global__ void __launch_bounds__(kGeluThreads)
bias_gelu_kernel(const T* __restrict__ u, const T* __restrict__ bias,
                 T* __restrict__ y, int rows, int features) {
  const int c = blockIdx.x * kGeluThreads + threadIdx.x;  // the column vector
  if (c >= features / kWidth) return;
  const size_t col = static_cast<size_t>(kWidth) * c;
  // the bias is loaded once and unpacked only after a group's loads of u
  // are issued: unpacked here, it would make the first group wait for it
  // before loading u, two memory latencies in a row
  Vec8<T> bias_v;
  T bias_s;
  if constexpr (kWidth == kVector) {
    bias_v = load8(bias + col);
  } else {
    bias_s = bias[col];
  }
  for (int r0 = blockIdx.y * kRows; r0 < rows; r0 += gridDim.y * kRows) {
    if constexpr (kWidth == kVector) {
      Vec8<T> uv[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {  // every load before any use
        if (r0 + k < rows) uv[k] = load8(u + static_cast<size_t>(r0 + k) * features + col);
      }
      float b[kVector];
      unpack(bias_v, b);
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (r0 + k < rows) {
          float t[kVector];
          unpack(uv[k], t);
#pragma unroll
          for (int j = 0; j < kVector; ++j) t[j] = gelu_erf(t[j] + b[j]);
          store8(y + static_cast<size_t>(r0 + k) * features + col, pack<T>(t));
        }
      }
    } else {
      T us[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (r0 + k < rows) us[k] = u[static_cast<size_t>(r0 + k) * features + col];
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (r0 + k < rows) {
          y[static_cast<size_t>(r0 + k) * features + col] =
              from_f32<T>(gelu_erf(to_f32(us[k]) + to_f32(bias_s)));
        }
      }
    }
  }
}

template <typename T, int kWidth, int kRows>
void launch_bias_gelu_rows(const void* u, const void* bias, void* y, int rows,
                           int features, int blocks_x, cudaStream_t stream) {
  const int groups = (rows + kRows - 1) / kRows;
  const dim3 grid(blocks_x, groups < kMaxGridY ? groups : kMaxGridY);
  bias_gelu_kernel<T, kWidth, kRows><<<grid, kGeluThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(bias), static_cast<T*>(y), rows,
      features);
}

template <typename T, int kWidth>
void launch_bias_gelu(const void* u, const void* bias, void* y, int rows, int features,
                      cudaStream_t stream) {
  const int blocks_x = (features / kWidth + kGeluThreads - 1) / kGeluThreads;
  // the most rows a thread that still leaves 4 blocks an SM
  int r = 8;
  while (r > 1 && static_cast<long long>(blocks_x) * ((rows + r - 1) / r) < 4LL * kSms) r /= 2;
  switch (r) {
    case 8: launch_bias_gelu_rows<T, kWidth, 8>(u, bias, y, rows, features, blocks_x, stream); break;
    case 4: launch_bias_gelu_rows<T, kWidth, 4>(u, bias, y, rows, features, blocks_x, stream); break;
    case 2: launch_bias_gelu_rows<T, kWidth, 2>(u, bias, y, rows, features, blocks_x, stream); break;
    default: launch_bias_gelu_rows<T, kWidth, 1>(u, bias, y, rows, features, blocks_x, stream);
  }
}

template <typename T>
void dispatch_bias_gelu(const void* u, const void* bias, void* y, int rows, int features,
                        cudaStream_t stream) {
  // 8-wide vectors once they leave 2 blocks an SM at one row a thread; a
  // smaller grid (decode's [8, 4096]: 32 blocks) runs one element a thread
  // on 8 times the blocks.  Measured at E = 4096, scalar against vectors:
  // 5% faster at 8 rows, 2% at 37, equal at 64, 6% slower at 128
  const long long vector_blocks =
      static_cast<long long>(rows) * ((features / kVector + kGeluThreads - 1) / kGeluThreads);
  if (features % kVector == 0 && aligned16(u) && aligned16(bias) && aligned16(y) &&
      vector_blocks >= 2LL * kSms) {
    launch_bias_gelu<T, kVector>(u, bias, y, rows, features, stream);
  } else {
    launch_bias_gelu<T, 1>(u, bias, y, rows, features, stream);
  }
}

}  // namespace

// Each entry point launches on `stream`, does not synchronise, allocates
// nothing, and returns cudaGetLastError() (0 when the launch was accepted).
// Arguments the kernels do not take return cudaErrorInvalidValue unlaunched.

extern "C" int pdt_add_layernorm(const void* x, const void* delta,
                                 const void* scale, const void* bias, void* s,
                                 void* y, int rows, int features, float eps,
                                 int dtype, int out_dtype, void* stream) {
  if (rows <= 0 || features <= 0 || features > kLnMaxFeatures) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && out_dtype == kF32) {
    dispatch_add_layernorm<float, float>(x, delta, sc, bi, s, y, rows, features, eps, st);
  } else if (dtype == kBF16 && out_dtype == kBF16) {
    dispatch_add_layernorm<__nv_bfloat16, __nv_bfloat16>(x, delta, sc, bi, s, y, rows, features, eps, st);
  } else if (dtype == kBF16 && out_dtype == kF32) {
    dispatch_add_layernorm<__nv_bfloat16, float>(x, delta, sc, bi, s, y, rows, features, eps, st);
  } else if (dtype == kF16 && out_dtype == kF16) {
    dispatch_add_layernorm<__half, __half>(x, delta, sc, bi, s, y, rows, features, eps, st);
  } else if (dtype == kF16 && out_dtype == kF32) {
    dispatch_add_layernorm<__half, float>(x, delta, sc, bi, s, y, rows, features, eps, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pdt_bias_gelu(const void* u, const void* bias, void* y, int rows,
                             int features, int dtype, void* stream) {
  if (rows <= 0 || features <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    dispatch_bias_gelu<float>(u, bias, y, rows, features, st);
  } else if (dtype == kBF16) {
    dispatch_bias_gelu<__nv_bfloat16>(u, bias, y, rows, features, st);
  } else if (dtype == kF16) {
    dispatch_bias_gelu<__half>(u, bias, y, rows, features, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
