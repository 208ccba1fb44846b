// Per-channel float32 sum and sum of squares (train-mode BatchNorm
// statistics) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel htr_vt_tpu/ops/bn_stats.py:_stats_kernel
// (:35-48), which bn_stats.py:_stats_local (:51-71) launches. The plain
// PyTorch version with the same inputs and outputs is
// htr_vt_torch/ops/bn_stats.py:bn_stats_reference.
//
//   x [N = B*H*W, C] (a channels-last NCHW tensor), bf16 or float32
//   sum[c] = sum_n x[n, c],  sumsq[c] = sum_n x[n, c]^2   (float32)
//
// What bounds it on this card: memory. It reads x once (805.3 MB in bf16 at
// the stem's entry activation [128, 192, 32, 512]) and writes 2*C floats, so
// the floor is bytes / 3.35 TB/s: 0.240 ms there. The arithmetic (two adds
// per element) is far below the card's rate.
//
// Design: each thread owns 8 channels, loaded as one 16-byte vector (bf16)
// or two (float32), so a warp reads contiguous bytes of a row. A block is
// (C/8 channel groups) x (rows) threads and strides over the rows with a
// fixed grid, four rows per step to keep loads in flight, summing in
// float32 registers. The block reduces its row slots through shared memory
// in order and writes one [2C] partial; stem_common.cuh:sum_partials adds
// the partials in a fixed order. No atomics, so the result is
// deterministic: two calls give equal bits. The TPU kernel's sequential
// grid, which carried the sums from one image to the next in its output
// block, becomes the row loop inside each block plus the second pass.

#include "stem_common.cuh"

namespace {

using stem::kVec;

constexpr int kUnroll = 4;

template <typename T>
__global__ void bn_stats_partial_kernel(const T* __restrict__ x,
                                        float* __restrict__ partial,
                                        long long N, int C) {
  extern __shared__ float red[];  // 2 * blockDim.y * C floats
  const int c0 = threadIdx.x * kVec;
  float s[kVec], q[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) s[i] = q[i] = 0.f;

  const long long step = static_cast<long long>(gridDim.x) * blockDim.y;
  long long row = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  for (; row + (kUnroll - 1) * step < N; row += kUnroll * step) {
    float v[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      stem::load8(x + (row + u * step) * C + c0, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        s[i] += v[u][i];
        q[i] += v[u][i] * v[u][i];
      }
    }
  }
  for (; row < N; row += step) {
    float v[kVec];
    stem::load8(x + row * C + c0, v);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      s[i] += v[i];
      q[i] += v[i] * v[i];
    }
  }
  stem::block_partials(s, q, red, partial, C);
}

template <typename T>
cudaError_t launch(const void* x, float* sum, float* sumsq, float* partial,
                   long long N, int C, int max_blocks, cudaStream_t stream) {
  const dim3 block = stem::block_shape(C);
  long long blocks = (N + block.y - 1) / block.y;
  if (blocks > max_blocks) blocks = max_blocks;
  const size_t smem = 2 * static_cast<size_t>(block.y) * C * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bn_stats_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  bn_stats_partial_kernel<T><<<static_cast<int>(blocks), block, smem, stream>>>(
      static_cast<const T*>(x), partial, N, C);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return stem::launch_sum_partials(partial, static_cast<int>(blocks), C, sum,
                                   sumsq, stream);
}

}  // namespace

// x [N, C] row-major (bf16 if dtype == 1, float32 if 0), 16-byte aligned,
// C % 8 == 0 and C / 8 <= 1024; sum and sumsq [C] float32 out; partial a
// float32 scratch of max_blocks * 2 * C (max_blocks >= 1). Launches two
// kernels on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int htrvt_bn_stats(const void* x, void* sum, void* sumsq,
                              void* partial, long long N, int C,
                              int max_blocks, int dtype, void* stream) {
  if (N <= 0 || C <= 0 || max_blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out0 = static_cast<float*>(sum);
  float* out1 = static_cast<float*>(sumsq);
  float* part = static_cast<float*>(partial);
  const cudaError_t err =
      dtype == stem::kBFloat16
          ? launch<__nv_bfloat16>(x, out0, out1, part, N, C, max_blocks, s)
          : launch<float>(x, out0, out1, part, N, C, max_blocks, s);
  return static_cast<int>(err);
}
