// Helpers shared by the stem kernels (bn_stats.cu, pool_fused.cu,
// conv_fused.cu).
//
// The stem's activations are channels-last: [rows, C] with C innermost.
// Every thread of these kernels owns kVec = 8 consecutive channels, so it
// moves 16 bytes of bf16 (one uint4) or 32 bytes of float32 (two float4)
// per access, and a warp reads a contiguous stretch of a row. Arithmetic is
// float32. Before a kernel uses these vector loads, its wrapper or launcher
// makes sure that C % 8 == 0 and that the base pointers are 16-byte
// aligned.
//
// Reductions across blocks never use float atomics: each block writes its
// partial sums to a float32 buffer, and they are added in a fixed order
// (sum_partials for K3b and K4d, the last block of each channel slice in
// bn_stats.cu), so two calls on the same input give equal bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stem {
namespace {  // internal linkage: each .cu file gets its own copy

constexpr int kVec = 8;

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ void load8(const float* p, float v[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Stores values that are already representable in the element type (the
// callers round first), so the conversion here is exact.
__device__ __forceinline__ void store8(float* p, const float v[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[kVec]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// float32 -> element type -> float32 (round to nearest even).
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// x * scale + shift in float32, rounded twice as the eager twin rounds (no
// FMA contraction), then cast to the element type and ReLU'd there.
template <typename T>
__device__ __forceinline__ float bn_relu(float x, float scale, float shift) {
  const float a = round_to<T>(__fadd_rn(__fmul_rn(x, scale), shift));
  return a > 0.f ? a : 0.f;
}

// out0[c] = sum_b partial[b, c], out1[c] = sum_b partial[b, C + c] for a
// [n_blocks, 2C] buffer, in a fixed order: lane y of a (32, 8) block sums
// the blocks y, y + 8, ... and the 8 lanes are added in order.
__global__ void sum_partials(const float* __restrict__ partial, int n_blocks,
                             int C, float* __restrict__ out0,
                             float* __restrict__ out1) {
  __shared__ float lanes[8][32];
  const int width = 2 * C;
  const int j = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (j < width) {
    for (int b = threadIdx.y; b < n_blocks; b += 8) {
      acc += partial[static_cast<size_t>(b) * width + j];
    }
  }
  lanes[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && j < width) {
    float total = 0.f;
#pragma unroll
    for (int y = 0; y < 8; ++y) total += lanes[y][threadIdx.x];
    if (j < C) {
      out0[j] = total;
    } else {
      out1[j - C] = total;
    }
  }
}

inline cudaError_t launch_sum_partials(const float* partial, int n_blocks,
                                       int C, float* out0, float* out1,
                                       cudaStream_t stream) {
  const dim3 block(32, 8);
  const int grid = (2 * C + 31) / 32;
  sum_partials<<<grid, block, 0, stream>>>(partial, n_blocks, C, out0, out1);
  return cudaGetLastError();
}

}  // namespace
}  // namespace stem
