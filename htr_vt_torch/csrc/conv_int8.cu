// Q1: the int8 (A8W8) convolution of the int8 serving stem, for Hopper,
// sm_90a: an implicit GEMM on the tensor cores, s8 x s8 -> s32.
//
// Replaces no Pallas kernel. The JAX package computes this convolution with
// XLA's conv_general_dilated on s8 operands with an s32 accumulator
// (htr_vt_tpu/ops/quant.py:55-88, conv_int8 and conv_int8_bf16), and stock
// PyTorch has no int8 convolution on CUDA. The plain PyTorch version with
// the same inputs and outputs is htr_vt_torch/ops/quant.py:
// conv_int8_reference (a float64 convolution of the integer values, exact).
//
// Layout: x [B, H, W, Ci] (a channels-last NCHW tensor), s8, or bf16 that
// quantize_kernel quantizes first; w [Co, KH, KW, Ci] s8 (per-channel scales);
// y [B, Ho, Wo, Co]. Zero padding P on both sides of H and W, of the
// QUANTIZED input (XLA pads xq), strides (SH, SW). Ci % 64 == 0 and
// Co % 128 == 0, as at every int8 site of the stem.
//
//   a     = x                                  (s8 input)
//   a     = max(T(T(x * T(s)) + T(t)), 0)      (bf16 input with a prologue,
//                                               T = bf16, each op rounded)
//   q     = clamp(rint(a / sx), -127, 127)     (bf16 input; true division,
//                                               round half to even)
//   acc   = sum_{kh, kw, ci} q[b, ho*SH-P+kh, wo*SW-P+kw, ci] * w[co,kh,kw,ci]
//   y     = acc                                (out s32)
//         = f32(acc) * dq[co]                  (out float32, conv_int8)
//         = bf16(bf16(acc) * bf16(dq[co]))     (out bf16, conv_int8_bf16)
//   dq = sx * sw. s32 -> bf16 goes through float32 (two roundings), as
//   XLA's convert does.
//
// What bounds it on this card: at the flagship's sites, the operations
// (2 * M * Co * K int8 ops at 1,979 TOP/s) against the bytes (x and y once,
// at 3.35 TB/s): stage 1's 3x3 256 -> 256 at [128, 8, 512] is 0.31 ms of
// operations and 0.08 ms of bytes.
//
// Design, the simple one: a block owns a 128 (output pixels) x 128 (output
// channels) tile and walks K in steps of 64 bytes (one tap, 64 input
// channels), 8 warps in a 2 x 4 grid, each warp 64 x 32 of the tile with
// mma.sync m16n8k32 (s8) and s32 accumulators in registers. A three-stage
// cp.async ring holds the A (gathered window rows) and B (weight rows)
// tiles in shared memory, rows padded to 80 bytes so that the fragment
// loads meet no bank conflict; the window row of each output pixel is
// gathered on load, taps outside the image zero-filled by cp.async's
// source size. A bf16 input is first normalised and quantized once, by
// quantize_kernel, into an s8 scratch tensor that the conv then reads:
// quantizing it on the conv's loads instead did the work again for each of
// the 9 taps and each 128-channel output tile, and ran the stage-1 3x3 at
// 17.5 ms against 1.45 ms from s8 (chip_smoke.py, H100 80GB HBM3, 700 W).
// wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace q1 {
namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;                 // bytes of K a step: one tap, 64 channels
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kRow = kBK + 16;          // shared row pitch in bytes
constexpr int kTile = kBM * kRow;       // one operand's tile: 10,240 bytes
constexpr int kSmem = kStages * 2 * kTile;  // 61,440 bytes

enum In : int { kInS8 = 0, kInBF16 = 1 };
enum Out : int { kOutS32 = 0, kOutF32 = 1, kOutBF16 = 2 };

struct Params {
  const void* x;           // s8
  const int8_t* w;
  const float* dq;         // [Co] sx * sw (float outputs)
  void* y;
  int B, H, W, Ci, Co, KH, KW, SH, SW, P, Ho, Wo;
  int M;                   // B * Ho * Wo
  int steps_per_tap;       // Ci / kBK
  int KT;                  // KH * KW * steps_per_tap
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The gather of one A row: which input pixel an output pixel reads at a tap.
struct RowInfo {
  int b, hi0, wi0;
  bool live;
};

__device__ __forceinline__ RowInfo row_info(const Params& p, int m) {
  RowInfo r;
  r.live = m < p.M;
  const int mm = r.live ? m : 0;
  const int wo = mm % p.Wo;
  const int t = mm / p.Wo;
  const int ho = t % p.Ho;
  r.b = t / p.Ho;
  r.hi0 = ho * p.SH - p.P;
  r.wi0 = wo * p.SW - p.P;
  return r;
}

// Element offset of the 16 channels a thread loads at step kt, or -1 for a
// zero (outside the image or past M).
__device__ __forceinline__ long long a_offset(const Params& p, const RowInfo& r, int kt,
                                              int chunk) {
  const int tap = kt / p.steps_per_tap;
  const int cb = kt - tap * p.steps_per_tap;
  const int kh = tap / p.KW;
  const int kw = tap - kh * p.KW;
  const int hi = r.hi0 + kh;
  const int wi = r.wi0 + kw;
  if (!r.live || hi < 0 || hi >= p.H || wi < 0 || wi >= p.W) return -1;
  return ((static_cast<long long>(r.b) * p.H + hi) * p.W + wi) * p.Ci + cb * kBK +
         chunk * 16;
}

// 16 bf16 channels -> 16 s8 codes packed in a uint4, with the prologue.
__device__ __forceinline__ uint4 quantize16(const uint4 raw[2], const float* pro_scale,
                                            const float* pro_shift, int ch0, float sx) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(raw);
  uint32_t packed[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = i * 4 + j;
      float a = __bfloat162float(h[e]);
      if (pro_scale != nullptr) {
        a = bf16_round(__fmul_rn(a, __ldg(pro_scale + ch0 + e)));
        a = bf16_round(__fadd_rn(a, __ldg(pro_shift + ch0 + e)));
        a = fmaxf(a, 0.0f);
      }
      int q = __float2int_rn(__fdiv_rn(a, sx));
      q = max(-127, min(127, q));
      word |= (static_cast<uint32_t>(q) & 0xffu) << (8 * j);
    }
    packed[i] = word;
  }
  return make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

// The bf16 input's quantization, once an element: x [rows, C] (C % 16 ==
// 0) -> q [rows, C] s8, 16 channels a thread (two 16-byte loads, one
// store), a grid-stride loop.
__global__ void __launch_bounds__(kThreads) quantize_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ sx,
    const float* __restrict__ pro_scale, const float* __restrict__ pro_shift,
    int8_t* __restrict__ q, long long groups, int C) {
  const float s = __ldg(sx);
  for (long long g = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       g < groups; g += static_cast<long long>(gridDim.x) * blockDim.x) {
    const uint4* src = reinterpret_cast<const uint4*>(x + g * 16);
    const uint4 raw[2] = {__ldg(src), __ldg(src + 1)};
    reinterpret_cast<uint4*>(q)[g] =
        quantize16(raw, pro_scale, pro_shift, static_cast<int>((g * 16) % C), s);
  }
}

template <int kOut>
__global__ void __launch_bounds__(kThreads) conv_int8_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sa = smem;                       // [kStages][kBM][kRow]
  uint8_t* sb = smem + kStages * kTile;     // [kStages][kBN][kRow]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // 0..1: 64 rows each
  const int wn = warp & 3;   // 0..3: 32 columns each
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const long long K = static_cast<long long>(p.KH) * p.KW * p.Ci;

  // Each thread loads 16 bytes of rows (tid >> 2) and (tid >> 2) + 64 of
  // both tiles, chunk tid & 3 of the row's 64 bytes.
  const int lrow = tid >> 2;
  const int chunk = tid & 3;
  RowInfo rows[2];
  rows[0] = row_info(p, m0 + lrow);
  rows[1] = row_info(p, m0 + lrow + 64);
  auto load_b = [&](int kt, int stage) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = lrow + 64 * i;
      const int8_t* src = p.w + (n0 + n) * K + static_cast<long long>(kt) * kBK + chunk * 16;
      cp_async16(smem_addr(sb + stage * kTile + n * kRow + chunk * 16), src, 16);
    }
  };
  auto load_a = [&](int kt, int stage) {
    const int8_t* x = static_cast<const int8_t*>(p.x);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long off = a_offset(p, rows[i], kt, chunk);
      cp_async16(smem_addr(sa + stage * kTile + (lrow + 64 * i) * kRow + chunk * 16),
                 off < 0 ? x : x + off, off < 0 ? 0 : 16);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  // Fill the ring's first kStages - 1 stages.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < p.KT) {
      load_a(s, s);
      load_b(s, s);
    }
    cp_commit();
  }

  for (int kt = 0; kt < p.KT; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    const int next_stage = next % kStages;
    if (next < p.KT) {
      load_a(next, next_stage);
      load_b(next, next_stage);
    }
    cp_commit();

    const uint8_t* a_tile = sa + (kt % kStages) * kTile;
    const uint8_t* b_tile = sb + (kt % kStages) * kTile;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t af[4][4];
      uint32_t bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const uint8_t* base = a_tile + (wm * 64 + mi * 16 + g) * kRow + ks * 32 + t4 * 4;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(base);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kRow);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kRow + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint8_t* base = b_tile + (wn * 32 + ni * 8 + g) * kRow + ks * 32 + t4 * 4;
        bfr[ni][0] = *reinterpret_cast<const uint32_t*>(base);
        bfr[ni][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  cp_wait<0>();

  // Epilogue: thread holds columns n, n + 1 of rows r and r + 8.
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + mi * 16 + g + 8 * half;
      if (m >= p.M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn * 32 + ni * 8 + t4 * 2;
        const int c0 = acc[mi][ni][2 * half];
        const int c1 = acc[mi][ni][2 * half + 1];
        const long long o = static_cast<long long>(m) * p.Co + n;
        if (kOut == kOutS32) {
          *reinterpret_cast<int2*>(static_cast<int32_t*>(p.y) + o) = make_int2(c0, c1);
        } else if (kOut == kOutF32) {
          const float2 v = make_float2(__fmul_rn(__int2float_rn(c0), __ldg(p.dq + n)),
                                       __fmul_rn(__int2float_rn(c1), __ldg(p.dq + n + 1)));
          *reinterpret_cast<float2*>(static_cast<float*>(p.y) + o) = v;
        } else {
          const float v0 = __fmul_rn(bf16_round(__int2float_rn(c0)), bf16_round(__ldg(p.dq + n)));
          const float v1 =
              __fmul_rn(bf16_round(__int2float_rn(c1)), bf16_round(__ldg(p.dq + n + 1)));
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.y) + o) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

template <int kOut>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = conv_int8_kernel<kOut>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.M + kBM - 1) / kBM, p.Co / kBN);
  kernel<<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace q1

// x: s8 (in_dtype 0), or bf16 (1), which quantize_kernel first writes into
// ``scratch`` (s8, x's shape) with the prologue when pro_scale is given.
extern "C" int htrvt_conv_int8(const void* x, int in_dtype, const void* sx,
                               const void* pro_scale, const void* pro_shift,
                               const void* w, const void* dq, void* y, void* scratch,
                               int out_dtype, int B, int H, int W, int Ci, int Co, int KH,
                               int KW, int SH, int SW, int P, int Ho, int Wo, void* stream) {
  using namespace q1;
  const long long M = static_cast<long long>(B) * Ho * Wo;
  if (B <= 0 || H <= 0 || W <= 0 || Ho <= 0 || Wo <= 0 || Ci % kBK || Co % kBN ||
      Ci <= 0 || Co <= 0 || KH <= 0 || KW <= 0 || SH <= 0 || SW <= 0 || P < 0 ||
      M > (1LL << 30) || (out_dtype != kOutS32 && dq == nullptr) ||
      (in_dtype != kInS8 && in_dtype != kInBF16) ||
      (in_dtype == kInBF16 && (sx == nullptr || scratch == nullptr)) ||
      ((pro_scale == nullptr) != (pro_shift == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kInBF16) {
    const long long groups = static_cast<long long>(B) * H * W * Ci / 16;
    const long long blocks = std::min<long long>((groups + kThreads - 1) / kThreads, 132LL * 16);
    quantize_kernel<<<static_cast<int>(blocks), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(sx),
        static_cast<const float*>(pro_scale), static_cast<const float*>(pro_shift),
        static_cast<int8_t*>(scratch), groups, Ci);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    x = scratch;
  }
  Params p;
  p.x = x;
  p.w = static_cast<const int8_t*>(w);
  p.dq = static_cast<const float*>(dq);
  p.y = y;
  p.B = B; p.H = H; p.W = W; p.Ci = Ci; p.Co = Co; p.KH = KH; p.KW = KW;
  p.SH = SH; p.SW = SW; p.P = P; p.Ho = Ho; p.Wo = Wo;
  p.M = static_cast<int>(M);
  p.steps_per_tap = Ci / kBK;
  p.KT = KH * KW * p.steps_per_tap;
  cudaError_t err;
  switch (out_dtype) {
    case kOutS32: err = launch<kOutS32>(p, s); break;
    case kOutF32: err = launch<kOutF32>(p, s); break;
    case kOutBF16: err = launch<kOutBF16>(p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
