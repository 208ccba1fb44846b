// BatchNorm-apply + ReLU + 3x3/(2,1) max-pool, forward and backward, for
// Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels htr_vt_tpu/ops/pool_fused.py:
// _pool_fwd_kernel (:62-69, launched by _pool_fwd_local :159-176) and
// _pool_bwd_kernel (:72-149, launched by _pool_bwd_local :179-206). The
// plain PyTorch versions with the same inputs and outputs are
// htr_vt_torch/ops/pool_fused.py:max_pool_bn_relu_reference and
// pool_bn_relu_bwd_reference.
//
// Layout: x [B, H, W, C] (a channels-last NCHW tensor), H even, bf16 or
// float32; scale, shift [C] float32 (the folded BN terms); y, g
// [B, H/2, W, C].
//
//   a[b,h,w,c]  = max(T(x * scale + shift), 0)      T = the element type
//   y[b,ho,w,c] = max over kh, kw in 0..2 of a[b, 2ho-1+kh, w-1+kw, c]
//                 (-inf outside the image)
//
// Backward (pool_bn_relu_bwd): each window's gradient goes to its first
// maximal tap in scan order (kh, kw row-major), as XLA's select-and-scatter
// routes it. An input element gathers, tap by tap in scan order, the
// gradient of every window whose argmax it is, adding in the element type
// (the TPU kernel's da_even/da_odd accumulators). Then, in float32:
//   da' = da if a_pre > 0, 0 if a_pre < 0, da / 2 at a_pre == 0
//   (jnp.maximum's gradient at a tie), a_pre = x * scale + shift
//   dx = T(da' * scale), dscale = sum da' * x, dshift = sum da'.
// x * scale + shift and da' * scale round like the eager twin (__fmul_rn /
// __fadd_rn, no FMA contraction), so y and dx are bit-equal to it.
//
// What bounds them on this card: memory. The forward reads x once and
// writes y (805.3 + 402.7 MB at the stem's [128, 192, 32, 512] bf16 entry:
// 0.361 ms at 3.35 TB/s); the backward reads g and x and writes dx
// (402.7 + 805.3 + 805.3 MB: 0.601 ms). The arithmetic (9 taps of a
// multiply-add and a compare per output) is below the card's rate.
//
// Design. Every thread owns 8 channels (16-byte bf16 vectors), blocks are
// (C/8 channel groups) x (positions). Forward: one thread per output
// position reads its 9 taps; the normalised tensor never exists in memory,
// and neighbouring windows re-read the same input rows from L1/L2.
// Backward: a gather, not a scatter, so no atomics. A block walks tiles of
// (b, two input rows 2ho0 and 2ho0+1, kTileW columns). Phase 1 recomputes
// the argmax tap of each window those rows reach (window rows ho0 and
// ho0+1, columns w0-1 .. w0+kTileW) from x and keeps it as one byte per
// channel in shared memory; phase 2 gives each input element its routed
// gradient, its ReLU backward and dx, and adds da' * x and da' to the
// thread's float32 dscale/dshift sums. The block's sums go through a
// fixed-order second pass (stem_common.cuh:sum_partials). The TPU kernel's
// W-chunking and read-modify-write of seam columns were VMEM workarounds;
// every element here is finished by one thread in one pass.

#include <math_constants.h>

#include "stem_common.cuh"

namespace {

using stem::kVec;

constexpr int kTileW = 32;            // input columns per backward tile
constexpr unsigned char kNone = 255;  // no window / no maximal tap

template <typename T>
__global__ void pool_fwd_kernel(const T* __restrict__ x,
                                const float* __restrict__ scale,
                                const float* __restrict__ shift,
                                T* __restrict__ y, int B, int H, int W, int C) {
  const int Ho = H / 2;
  const long long pos = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (pos >= static_cast<long long>(B) * Ho * W) return;
  const int c0 = threadIdx.x * kVec;
  const int w = static_cast<int>(pos % W);
  const long long bh = pos / W;
  const int ho = static_cast<int>(bh % Ho);
  const long long b = bh / Ho;

  float sc[kVec], sh[kVec], m[kVec];
  stem::load8(scale + c0, sc);
  stem::load8(shift + c0, sh);
#pragma unroll
  for (int i = 0; i < kVec; ++i) m[i] = -CUDART_INF_F;
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) {
    const int h = 2 * ho - 1 + kh;
    if (h < 0 || h >= H) continue;
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      const int wi = w - 1 + kw;
      if (wi < 0 || wi >= W) continue;
      float v[kVec];
      stem::load8(x + ((b * H + h) * W + wi) * C + c0, v);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float a = stem::bn_relu<T>(v[i], sc[i], sh[i]);
        m[i] = a > m[i] ? a : m[i];
      }
    }
  }
  stem::store8(y + pos * C + c0, m);
}

// First maximal tap (0..8, scan order) of window (b, ho, wo) per channel.
template <typename T>
__device__ __forceinline__ void window_argmax(const T* __restrict__ x,
                                              const float sc[kVec],
                                              const float sh[kVec],
                                              long long b, int ho, int wo,
                                              int H, int W, int C, int c0,
                                              unsigned char* arg) {
  float m[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    m[i] = -CUDART_INF_F;
    arg[i] = kNone;
  }
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) {
    const int h = 2 * ho - 1 + kh;
    if (h < 0 || h >= H) continue;
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      const int wi = wo - 1 + kw;
      if (wi < 0 || wi >= W) continue;
      float v[kVec];
      stem::load8(x + ((b * H + h) * W + wi) * C + c0, v);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float a = stem::bn_relu<T>(v[i], sc[i], sh[i]);
        if (a > m[i]) {  // strict: a tie keeps the earlier tap
          m[i] = a;
          arg[i] = static_cast<unsigned char>(kh * 3 + kw);
        }
      }
    }
  }
}

template <typename T>
__global__ void pool_bwd_kernel(const T* __restrict__ g,
                                const T* __restrict__ x,
                                const float* __restrict__ scale,
                                const float* __restrict__ shift,
                                T* __restrict__ dx, float* __restrict__ partial,
                                int B, int H, int W, int C) {
  // argmax[r][j][c]: window row ho0 + r, column w0 - 1 + j. After the tile
  // loop the same memory holds the block reduction (block_partials).
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kCols = kTileW + 2;
  const int Ho = H / 2;
  const int c0 = threadIdx.x * kVec;
  const int n_wt = (W + kTileW - 1) / kTileW;
  const long long n_tiles = static_cast<long long>(B) * Ho * n_wt;

  float sc[kVec], sh[kVec], ds[kVec], dt[kVec];
  stem::load8(scale + c0, sc);
  stem::load8(shift + c0, sh);
#pragma unroll
  for (int i = 0; i < kVec; ++i) ds[i] = dt[i] = 0.f;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int w0 = static_cast<int>(tile % n_wt) * kTileW;
    const long long bh = tile / n_wt;
    const int ho0 = static_cast<int>(bh % Ho);
    const long long b = bh / Ho;

    // Phase 1: the argmax of every window these two input rows reach.
    for (int k = threadIdx.y; k < 2 * kCols; k += blockDim.y) {
      const int r = k / kCols;
      const int j = k - r * kCols;
      const int ho = ho0 + r;
      const int wo = w0 - 1 + j;
      uint2 packed;
      unsigned char* arg = reinterpret_cast<unsigned char*>(&packed);
      if (ho < Ho && wo >= 0 && wo < W) {
        window_argmax<T>(x, sc, sh, b, ho, wo, H, W, C, c0, arg);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) arg[i] = kNone;
      }
      *reinterpret_cast<uint2*>(
          smem + (static_cast<size_t>(r) * kCols + j) * C + c0) = packed;
    }
    __syncthreads();

    // Phase 2: each input element gathers its routed gradient.
    for (int k = threadIdx.y; k < 2 * kTileW; k += blockDim.y) {
      const int r = k / kTileW;
      const int w = w0 + (k - r * kTileW);
      if (w >= W) continue;
      const int h = 2 * ho0 + r;
      float da[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) da[i] = 0.f;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        const int hp = h + 1 - kh;  // = 2 * ho if tap kh of window ho is h
        if (hp < 0 || (hp & 1)) continue;
        const int ho = hp >> 1;
        if (ho >= Ho) continue;
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const int wo = w + 1 - kw;
          if (wo < 0 || wo >= W) continue;
          const unsigned char tap = static_cast<unsigned char>(kh * 3 + kw);
          const uint2 packed = *reinterpret_cast<const uint2*>(
              smem + (static_cast<size_t>(ho - ho0) * kCols + (wo - w0 + 1)) * C + c0);
          const unsigned char* arg = reinterpret_cast<const unsigned char*>(&packed);
          bool any = false;
#pragma unroll
          for (int i = 0; i < kVec; ++i) any |= arg[i] == tap;
          if (!any) continue;
          float gv[kVec];
          stem::load8(g + ((b * Ho + ho) * W + wo) * C + c0, gv);
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            if (arg[i] == tap) da[i] = stem::round_to<T>(da[i] + gv[i]);
          }
        }
      }
      const long long at = ((b * H + h) * W + w) * C + c0;
      float xv[kVec], out[kVec];
      stem::load8(x + at, xv);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float a_pre = __fadd_rn(__fmul_rn(xv[i], sc[i]), sh[i]);
        const float d = a_pre > 0.f ? da[i] : (a_pre < 0.f ? 0.f : 0.5f * da[i]);
        out[i] = stem::round_to<T>(__fmul_rn(d, sc[i]));
        ds[i] += d * xv[i];
        dt[i] += d;
      }
      stem::store8(dx + at, out);
    }
    __syncthreads();  // phase 1 of the next tile overwrites the argmax
  }
  stem::block_partials(ds, dt, reinterpret_cast<float*>(smem), partial, C);
}

template <typename T>
cudaError_t launch_fwd(const void* x, const float* scale, const float* shift,
                       void* y, int B, int H, int W, int C,
                       cudaStream_t stream) {
  const dim3 block = stem::block_shape(C);
  const long long positions = static_cast<long long>(B) * (H / 2) * W;
  const long long blocks = (positions + block.y - 1) / block.y;
  pool_fwd_kernel<T><<<static_cast<unsigned>(blocks), block, 0, stream>>>(
      static_cast<const T*>(x), scale, shift, static_cast<T*>(y), B, H, W, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* x, const float* scale,
                       const float* shift, void* dx, float* dscale,
                       float* dshift, float* partial, int B, int H, int W,
                       int C, int max_blocks, cudaStream_t stream) {
  const dim3 block = stem::block_shape(C);
  const long long tiles =
      static_cast<long long>(B) * (H / 2) * ((W + kTileW - 1) / kTileW);
  const int blocks = static_cast<int>(tiles < max_blocks ? tiles : max_blocks);
  const size_t argmax_bytes = 2 * static_cast<size_t>(kTileW + 2) * C;
  const size_t reduce_bytes = 2 * static_cast<size_t>(block.y) * C * sizeof(float);
  const size_t smem = argmax_bytes > reduce_bytes ? argmax_bytes : reduce_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pool_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  pool_bwd_kernel<T><<<blocks, block, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), scale, shift,
      static_cast<T*>(dx), partial, B, H, W, C);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return stem::launch_sum_partials(partial, blocks, C, dscale, dshift, stream);
}

}  // namespace

// x [B, H, W, C] row-major (bf16 if dtype == 1, float32 if 0), H even,
// C % 8 == 0 and C / 8 <= 1024, every pointer 16-byte aligned; scale/shift
// [C] float32; y [B, H/2, W, C] out. Returns cudaGetLastError().
extern "C" int htrvt_pool_bn_relu_fwd(const void* x, const void* scale,
                                      const void* shift, void* y, int B, int H,
                                      int W, int C, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || (H & 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const cudaError_t err =
      dtype == stem::kBFloat16
          ? launch_fwd<__nv_bfloat16>(x, sc, sh, y, B, H, W, C, s)
          : launch_fwd<float>(x, sc, sh, y, B, H, W, C, s);
  return static_cast<int>(err);
}

// g [B, H/2, W, C] and x [B, H, W, C] (same dtype, layout and rules as the
// forward); dx [B, H, W, C] out; dscale, dshift [C] float32 out; partial a
// float32 scratch of max_blocks * 2 * C. Returns cudaGetLastError().
extern "C" int htrvt_pool_bn_relu_bwd(const void* g, const void* x,
                                      const void* scale, const void* shift,
                                      void* dx, void* dscale, void* dshift,
                                      void* partial, int B, int H, int W,
                                      int C, int max_blocks, int dtype,
                                      void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || (H & 1) || max_blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  float* ds = static_cast<float*>(dscale);
  float* dt = static_cast<float*>(dshift);
  float* part = static_cast<float*>(partial);
  const cudaError_t err =
      dtype == stem::kBFloat16
          ? launch_bwd<__nv_bfloat16>(g, x, sc, sh, dx, ds, dt, part, B, H, W,
                                      C, max_blocks, s)
          : launch_bwd<float>(g, x, sc, sh, dx, ds, dt, part, B, H, W, C,
                              max_blocks, s);
  return static_cast<int>(err);
}
