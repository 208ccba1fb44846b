// Per-channel float32 sum and sum of squares (train-mode BatchNorm
// statistics) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel htr_vt_tpu/ops/bn_stats.py:_stats_kernel
// (:35-48), which bn_stats.py:_stats_local (:51-71) launches. The plain
// PyTorch version with the same inputs and outputs is
// htr_vt_torch/ops/bn_stats.py:bn_stats_reference.
//
//   x [N = B*H*W, C] (a channels-last NCHW tensor), bf16 or float32, any C
//   sum[c] = sum_n x[n, c],  sumsq[c] = sum_n x[n, c]^2   (float32)
//
// What bounds it on this card: memory. It reads x once (805.3 MB in bf16 at
// the stem's entry activation [128, 192, 32, 512], 50.3 MB at stage 3's
// [128, 768, 2, 128]) and writes 2*C floats, so the floor is bytes / 3.35
// TB/s: 0.240 ms and 0.015 ms there. The arithmetic (two adds per element)
// is far below the card's rate. At the small sites what does not scale
// with the bytes decides: the launch, the ramp, and the cross-block sum.
//
// Design: one launch, sized to the card (ops/bn_stats.py:stats_geometry).
// - The channels are cut into slices of at most 32 groups of 8 channels
//   (256 channels: one warp covers a slice's row). blockIdx.y is the slice,
//   and the slice's blocks (about one block of 1024 threads a SM over all
//   slices) stride over the rows, so each thread walks its rows with 8
//   rows' loads in flight (16 bytes each in bf16: 128 KB a SM, enough to
//   cover the memory's latency under load), summing in float32 registers. With C % 8 == 0 (and x 16-byte aligned) a thread's 8
//   channels come as one vector; otherwise as scalars, the channels past C
//   reading zero, so any C is taken.
// - The block adds its row slots through shared memory in a fixed order and
//   writes one partial row of its slice; then a ticket: the block's threads
//   fence their stores, one thread takes a number from the slice's counter,
//   and the block that takes the last number adds the slice's partials in
//   block order (float4 loads, many independent loads a thread, a fixed
//   split of the rows over four or more thread sets joined in order),
//   writes sum and sumsq, and puts the counter back to 0 for the next call.
//   The last blocks of the slices do their sums in parallel, each over at
//   most a few hundred kilobytes.
// No float atomics, so the result is deterministic: two calls give equal
// bits. The TPU kernel's sequential grid, which carried the sums from one
// image to the next in its output block, becomes the row loop inside each
// block plus the last block's sum.

#include "stem_common.cuh"

namespace {

using stem::kVec;

constexpr int kThreads = 1024;
constexpr int kUnroll = 8;            // rows in flight a thread
constexpr int kMaxSliceGroups = 32;   // channel groups of 8 a slice

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Thread (g, r) of a block: g = tid % G is the channel group within the
// slice, r = tid / G the row slot (R = kThreads / G slots; the threads past
// R * G stay idle).
template <typename T, bool kVector>
__device__ __forceinline__ void load_row(const T* __restrict__ x, long long row, int C, int c0,
                                         float v[kVec]) {
  const T* p = x + row * C + c0;
  if (kVector) {
    stem::load8(p, v);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = c0 + i < C ? to_float(p[i]) : 0.f;
  }
}

template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads, 1)
bn_stats_kernel(const T* __restrict__ x, float* __restrict__ partial,
                unsigned* __restrict__ tickets, float* __restrict__ sum,
                float* __restrict__ sumsq, long long N, int C, int G) {
  __shared__ __align__(16) float red[kThreads * kVec];  // 32 KB
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int R = kThreads / G;
  const int g = tid % G, r = tid / G;
  const int W = G * kVec;                      // a slice's channels
  const int slice_c0 = blockIdx.y * W;         // its first channel
  const int c0 = slice_c0 + g * kVec;          // the thread's first channel
  const int P = gridDim.x;                     // blocks of the slice
  const bool active = r < R && c0 < C;

  float s[kVec], q[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) s[i] = q[i] = 0.f;
  if (active) {
    const long long step = static_cast<long long>(P) * R;
    for (long long row = static_cast<long long>(blockIdx.x) * R + r; row < N;
         row += kUnroll * step) {
      float v[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (row + u * step < N) {
          load_row<T, kVector>(x, row + u * step, C, c0, v[u]);
        } else {
#pragma unroll
          for (int i = 0; i < kVec; ++i) v[u][i] = 0.f;
        }
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
  }

  // the block's partial row: [sum of the slice's W channels, then sumsq],
  // its R row slots added in order; the sums, then the squares, through
  // the same shared buffer
  float* slice_partials = partial + static_cast<size_t>(blockIdx.y) * P * 2 * W;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    if (r < R) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) red[r * W + g * kVec + i] = which ? q[i] : s[i];
    }
    __syncthreads();
    if (tid < W) {
      float acc = 0.f;
      for (int k = 0; k < R; ++k) acc += red[k * W + tid];
      slice_partials[static_cast<size_t>(blockIdx.x) * 2 * W + which * W + tid] = acc;
      __threadfence();  // the partial is visible before the ticket is taken
    }
    __syncthreads();
  }
  if (tid == 0) last = atomicAdd(&tickets[blockIdx.y], 1u) == static_cast<unsigned>(P - 1);
  __syncthreads();
  if (!last) return;

  // The slice's last block: partial rows 0..P-1 added in order. Thread set
  // k of K adds rows k, k + K, ... of its four columns; the K sums are then
  // added in order.
  __threadfence();
  const int quads = 2 * W / 4;
  const int K = kThreads / quads;
  const int j = tid % quads, k = tid / quads;
  float4* red4 = reinterpret_cast<float4*>(red);
  if (k < K) {
    const float4* col = reinterpret_cast<const float4*>(slice_partials) + j;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int row = k; row < P; row += K) {
      const float4 v = __ldcg(col + static_cast<size_t>(row) * quads);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    red4[k * quads + j] = acc;
  }
  __syncthreads();
  if (tid < quads) {
    float4 total = red4[tid];
    for (int kk = 1; kk < K; ++kk) {
      const float4 v = red4[kk * quads + tid];
      total.x += v.x;
      total.y += v.y;
      total.z += v.z;
      total.w += v.w;
    }
    const float vals[4] = {total.x, total.y, total.z, total.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 4 * tid + e;
      const int which = col / W, c = slice_c0 + col - which * W;
      if (c < C) (which ? sumsq : sum)[c] = vals[e];
    }
  }
  if (tid == 0) tickets[blockIdx.y] = 0u;
}

template <typename T>
cudaError_t launch(const void* x, float* sum, float* sumsq, float* partial,
                   unsigned* tickets, long long N, int C, int G, int blocks,
                   cudaStream_t stream) {
  const int slices = (C + G * kVec - 1) / (G * kVec);
  const dim3 grid(blocks, slices);
  const bool vector = C % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  if (vector) {
    bn_stats_kernel<T, true><<<grid, kThreads, 0, stream>>>(xt, partial, tickets, sum, sumsq,
                                                            N, C, G);
  } else {
    bn_stats_kernel<T, false><<<grid, kThreads, 0, stream>>>(xt, partial, tickets, sum, sumsq,
                                                             N, C, G);
  }
  return cudaGetLastError();
}

}  // namespace

// x [N, C] row-major (bf16 if dtype == 1, float32 if 0), any C; sum and sumsq
// [C] float32 out. The geometry comes from ops/bn_stats.py:stats_geometry:
// `slice_groups` (1..32) channel groups of 8 a slice and `blocks` blocks a
// slice. `partial` is a float32 scratch of slices * blocks * 2 * 8 *
// slice_groups, `tickets` slices unsigned ints that are 0 before the launch
// and are 0 again after it. Launches one kernel on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int htrvt_bn_stats(const void* x, void* sum, void* sumsq, void* partial,
                              void* tickets, long long N, int C, int slice_groups,
                              int blocks, int dtype, void* stream) {
  if (N <= 0 || C <= 0 || slice_groups < 1 || slice_groups > kMaxSliceGroups ||
      blocks < 1 || blocks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out0 = static_cast<float*>(sum);
  float* out1 = static_cast<float*>(sumsq);
  float* part = static_cast<float*>(partial);
  unsigned* tick = static_cast<unsigned*>(tickets);
  const cudaError_t err =
      dtype == stem::kBFloat16
          ? launch<__nv_bfloat16>(x, out0, out1, part, tick, N, C, slice_groups, blocks, s)
          : launch<float>(x, out0, out1, part, tick, N, C, slice_groups, blocks, s);
  return static_cast<int>(err);
}
