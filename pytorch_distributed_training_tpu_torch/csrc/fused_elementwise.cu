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
// operations and one erff per element) is far below the f32 rate. The
// design keeps every intermediate out of device memory: add_layernorm holds
// its row of s in registers between the statistics and the normalisation,
// so the sum that the unfused pair would store and read back twice is read
// zero times. On the TPU a grid step covered a 256-row tile held in VMEM;
// here one thread block owns one row and the rows run in parallel.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

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

// ---------------------------------------------------------------------------
// residual add + LayerNorm: one block per row, a strided loop over features.

constexpr int kLnThreads = 256;
constexpr int kLnWarps = kLnThreads / 32;
constexpr int kLnMaxPerThread = 32;
constexpr int kLnMaxFeatures = kLnThreads * kLnMaxPerThread;  // 8192

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

template <typename T, typename U>
__global__ void __launch_bounds__(kLnThreads)
add_layernorm_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, T* __restrict__ s_out,
                     U* __restrict__ y_out, int features, float eps) {
  const size_t base = static_cast<size_t>(blockIdx.x) * features;
  // the row's rounded sum stays in registers: the loop is unrolled, so
  // every index into `vals` is a compile-time constant
  float vals[kLnMaxPerThread];
  float sum = 0.f;
  float sumsq = 0.f;
#pragma unroll
  for (int k = 0; k < kLnMaxPerThread; ++k) {
    const int col = threadIdx.x + k * kLnThreads;
    vals[k] = 0.f;
    if (col < features) {
      // the statistics read the ROUNDED sum, as the unfused LayerNorm would
      const T s = from_f32<T>(to_f32(x[base + col]) + to_f32(delta[base + col]));
      s_out[base + col] = s;
      const float v = to_f32(s);
      vals[k] = v;
      sum += v;
      sumsq += v * v;
    }
  }

  __shared__ float partial[2][kLnWarps];
  __shared__ float stats[2];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  sum = warp_sum(sum);
  sumsq = warp_sum(sumsq);
  if (lane == 0) {
    partial[0][warp] = sum;
    partial[1][warp] = sumsq;
  }
  __syncthreads();
  if (warp == 0) {
    float a = lane < kLnWarps ? partial[0][lane] : 0.f;
    float b = lane < kLnWarps ? partial[1][lane] : 0.f;
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      const float mu = a / static_cast<float>(features);
      const float var = fmaxf(0.f, b / static_cast<float>(features) - mu * mu);
      stats[0] = mu;
      stats[1] = rsqrtf(var + eps);
    }
  }
  __syncthreads();
  const float mu = stats[0];
  const float rstd = stats[1];
#pragma unroll
  for (int k = 0; k < kLnMaxPerThread; ++k) {
    const int col = threadIdx.x + k * kLnThreads;
    if (col < features) {
      const float xhat = (vals[k] - mu) * rstd;
      y_out[base + col] = from_f32<U>(xhat * scale[col] + bias[col]);
    }
  }
}

template <typename T, typename U>
void launch_add_layernorm(const void* x, const void* delta, const float* scale,
                          const float* bias, void* s, void* y, int rows,
                          int features, float eps, cudaStream_t stream) {
  add_layernorm_kernel<T, U><<<rows, kLnThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(delta), scale, bias,
      static_cast<T*>(s), static_cast<U*>(y), features, eps);
}

// ---------------------------------------------------------------------------
// bias + exact GELU: grid-stride over rows (grid y) and columns (grid x), so
// the bias column comes from the index without a division.

constexpr int kGeluThreads = 256;
constexpr int kMaxGridY = 65535;

template <typename T>
__global__ void __launch_bounds__(kGeluThreads)
bias_gelu_kernel(const T* __restrict__ u, const T* __restrict__ bias,
                 T* __restrict__ y, int rows, int features) {
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const size_t base = static_cast<size_t>(row) * features;
    for (int col = blockIdx.x * blockDim.x + threadIdx.x; col < features;
         col += gridDim.x * blockDim.x) {
      const float t = to_f32(u[base + col]) + to_f32(bias[col]);
      y[base + col] = from_f32<T>(0.5f * t * (1.f + erff(t * 0.70710678118654752f)));
    }
  }
}

template <typename T>
void launch_bias_gelu(const void* u, const void* bias, void* y, int rows,
                      int features, cudaStream_t stream) {
  const dim3 grid((features + kGeluThreads - 1) / kGeluThreads,
                  rows < kMaxGridY ? rows : kMaxGridY);
  bias_gelu_kernel<T><<<grid, kGeluThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(bias), static_cast<T*>(y),
      rows, features);
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
    launch_add_layernorm<float, float>(x, delta, sc, bi, s, y, rows, features, eps, st);
  } else if (dtype == kBF16 && out_dtype == kBF16) {
    launch_add_layernorm<__nv_bfloat16, __nv_bfloat16>(x, delta, sc, bi, s, y, rows, features, eps, st);
  } else if (dtype == kBF16 && out_dtype == kF32) {
    launch_add_layernorm<__nv_bfloat16, float>(x, delta, sc, bi, s, y, rows, features, eps, st);
  } else if (dtype == kF16 && out_dtype == kF16) {
    launch_add_layernorm<__half, __half>(x, delta, sc, bi, s, y, rows, features, eps, st);
  } else if (dtype == kF16 && out_dtype == kF32) {
    launch_add_layernorm<__half, float>(x, delta, sc, bi, s, y, rows, features, eps, st);
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
    launch_bias_gelu<float>(u, bias, y, rows, features, st);
  } else if (dtype == kBF16) {
    launch_bias_gelu<__nv_bfloat16>(u, bias, y, rows, features, st);
  } else if (dtype == kF16) {
    launch_bias_gelu<__half>(u, bias, y, rows, features, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
