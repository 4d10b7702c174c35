// Fused softmax cross-entropy, written by hand for Hopper (sm_90a), with a
// plain C interface that the Python side binds with ctypes
// (pytorch_distributed_training_tpu_torch/kernels/__init__.py).
//
// ce_fwd replaces the TPU kernel `_fwd_kernel`
// (pytorch_distributed_training_tpu/ops/fused_ce.py:56, launched at :108):
// per row of the [B, C] logits, in f32 whatever the logits dtype, the max,
// lse = m + log(sum(exp(x - m))) and nll = lse - x[label]; both [B] f32 are
// written and the mean is taken outside. A label outside [0, C) contributes
// a true logit of 0 (a finite, wrong loss), as the TPU kernel's iota compare
// does; nothing raises inside the kernel.
//
// ce_bwd replaces `_bwd_kernel` (same file, :70, launched at :143):
// dlogits = (exp(x - lse) - onehot(label)) * g, with g = dloss / B read
// from device memory (no host sync), written in the logits dtype.
//
// Bound: memory traffic. The forward reads each logit once (2.15 GB for the
// LM's [16384, 32768] f32 logits: 0.64 ms at 3.35 TB/s); the backward reads
// and writes each once. One exp per element is far below the card's rate.
// Design: one thread block per row and 16-byte loads; each thread keeps an
// online (max, sum) pair over its strided chunks of the row, so the row is
// read once however wide C is, and the pairs are merged across the block.
// The TPU kernel's 128-row, 2 MB VMEM tile has no counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum DType : int { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC elements of T as one aligned load/store (16 bytes when VEC * sizeof(T)
// is 16; VEC is 1 for rows that are not 16-byte aligned).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// merge two online-softmax partials (m, s): s counts exp(x - m)
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;  // both empty
  s = (m == -INFINITY ? 0.f : s * expf(m - mx)) +
      (m2 == -INFINITY ? 0.f : s2 * expf(m2 - mx));
  m = mx;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
              float* __restrict__ nll, float* __restrict__ lse, int classes) {
  const int row = blockIdx.x;
  const T* x = logits + static_cast<size_t>(row) * classes;
  float m = -INFINITY;
  float s = 0.f;
  for (int col = threadIdx.x * VEC; col < classes; col += kThreads * VEC) {
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(x + col);
    float v[VEC];
    float cmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      v[i] = to_f32(p.v[i]);
      cmax = fmaxf(cmax, v[i]);
    }
    if (cmax > m) {
      s = (m == -INFINITY) ? 0.f : s * expf(m - cmax);
      m = cmax;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) s += expf(v[i] - m);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  __shared__ float part_m[kWarps];
  __shared__ float part_s[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    part_m[warp] = m;
    part_s[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? part_m[lane] : -INFINITY;
    s = lane < kWarps ? part_s[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
      merge(m, s, m2, s2);
    }
    if (lane == 0) {
      const float l = m + logf(s);
      const int label = labels[row];
      const float true_logit =
          (label >= 0 && label < classes) ? to_f32(x[label]) : 0.f;
      nll[row] = l - true_logit;
      lse[row] = l;
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
ce_bwd_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
              const float* __restrict__ lse, const float* __restrict__ scale,
              T* __restrict__ dlogits, int classes) {
  const int row = blockIdx.x;
  const size_t base = static_cast<size_t>(row) * classes;
  const float l = lse[row];
  const float g = scale[0];
  const int label = labels[row];
  for (int col = threadIdx.x * VEC; col < classes; col += kThreads * VEC) {
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(logits + base + col);
    Pack<T, VEC> out;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float prob = expf(to_f32(p.v[i]) - l);
      const float onehot = (col + i == label) ? 1.f : 0.f;
      out.v[i] = from_f32<T>((prob - onehot) * g);
    }
    *reinterpret_cast<Pack<T, VEC>*>(dlogits + base + col) = out;
  }
}

template <typename T>
bool aligned16(const void* p, int classes) {
  constexpr int vec = 16 / sizeof(T);
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && (classes % vec == 0);
}

template <typename T>
void launch_fwd(const void* logits, const int* labels, float* nll, float* lse,
                int rows, int classes, cudaStream_t st) {
  constexpr int vec = 16 / sizeof(T);
  const T* x = static_cast<const T*>(logits);
  if (aligned16<T>(logits, classes)) {
    ce_fwd_kernel<T, vec><<<rows, kThreads, 0, st>>>(x, labels, nll, lse, classes);
  } else {
    ce_fwd_kernel<T, 1><<<rows, kThreads, 0, st>>>(x, labels, nll, lse, classes);
  }
}

template <typename T>
void launch_bwd(const void* logits, const int* labels, const float* lse,
                const float* scale, void* dlogits, int rows, int classes,
                cudaStream_t st) {
  constexpr int vec = 16 / sizeof(T);
  const T* x = static_cast<const T*>(logits);
  T* d = static_cast<T*>(dlogits);
  if (aligned16<T>(logits, classes) && aligned16<T>(dlogits, classes)) {
    ce_bwd_kernel<T, vec><<<rows, kThreads, 0, st>>>(x, labels, lse, scale, d, classes);
  } else {
    ce_bwd_kernel<T, 1><<<rows, kThreads, 0, st>>>(x, labels, lse, scale, d, classes);
  }
}

}  // namespace

// Each entry point launches on `stream`, does not synchronise, allocates
// nothing, and returns cudaGetLastError() (0 when the launch was accepted).
// Arguments the kernels do not take return cudaErrorInvalidValue unlaunched.

extern "C" int pdt_ce_fwd(const void* logits, const void* labels, void* nll,
                          void* lse, int rows, int classes, int dtype,
                          void* stream) {
  if (rows <= 0 || classes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int* lab = static_cast<const int*>(labels);
  float* n = static_cast<float*>(nll);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    launch_fwd<float>(logits, lab, n, l, rows, classes, st);
  } else if (dtype == kBF16) {
    launch_fwd<__nv_bfloat16>(logits, lab, n, l, rows, classes, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pdt_ce_bwd(const void* logits, const void* labels,
                          const void* lse, const void* scale, void* dlogits,
                          int rows, int classes, int dtype, void* stream) {
  if (rows <= 0 || classes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int* lab = static_cast<const int*>(labels);
  const float* l = static_cast<const float*>(lse);
  const float* g = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    launch_bwd<float>(logits, lab, l, g, dlogits, rows, classes, st);
  } else if (dtype == kBF16) {
    launch_bwd<__nv_bfloat16>(logits, lab, l, g, dlogits, rows, classes, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
