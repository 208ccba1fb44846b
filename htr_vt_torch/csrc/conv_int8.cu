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
// quantize_kernel quantizes first; w [Co, KH, KW, Ci] s8 (per-channel
// scales); y [B, Ho, Wo, Co]. Zero padding P on both sides of H and W, of
// the QUANTIZED input (XLA pads xq), strides (SH, SW). Ci % 64 == 0 and
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
// What bounds it on this card: at the flagship's 3x3 sites, the operations
// (2 * M * Co * K int8 ops at 1,979 TOP/s) against the bytes (x and y once,
// at 3.35 TB/s): stage 1's 3x3 256 -> 256 at [128, 8, 512] is 0.31 ms of
// operations and 0.08 ms of bytes; the 1x1 projections are bound by bytes.
//
// Design: two routes, picked inside htrvt_conv_int8 by shape (q1_plan;
// htrvt_conv_int8_route says which route a shape takes). A bf16 input is
// first normalised and quantized once an element by quantize_kernel into an
// s8 scratch tensor that either route then reads. quantize_kernel rounds
// a * (1 / sx) by adding 1.5 * 2^23 and redoes by true division the few
// values that land within 3e-5 of a rounding tie, so its codes are those of
// the true division.
//
// The tensor-core route (conv_int8_wgmma), for 3x3 and padding-free 1x1
// kernels whose window fits in shared memory: K4f's structure
// (conv_fused.cu) in s8. A persistent, warp-specialised block per SM walks
// output tiles of 128 pixels (TH image rows x TW columns of one image, TH =
// 8, 4, 2 or 1 by the output's height) x BN output channels (256, 192 or
// 128: the widest that divides Co and leaves three weight stages), the
// channels innermost so that neighbouring blocks share a window in L2. Per
// 128-channel chunk of the input, the first thread of the producer
// warpgroup brings the tile's window ((TH - 1) * SH + 3 rows x (TW - 1) *
// SW + 3 columns of s8 codes, the one-pixel halo included) into one of two
// 128-byte-swizzled buffers by one TMA box, whose zero fill outside the
// tensor is the quantized input's zero padding, and each tap's weights
// ([BN][128] boxes of the packed weight, K-major) into a ring. A 1x1 kernel
// with stride (SH, SW) reads a strided view of x (the map's row and column
// strides times the conv's), so its window is exactly the tile's input
// pixels. Two consumer warpgroups each own 64 of the tile's pixels: for
// each tap they load their A fragments from the window shifted by the tap
// with ldmatrix (b16, no .trans: 16-byte rows of s8 codes are the m16n8k32
// s8 fragment; one address a row, so any shift and stride) while the
// previous tap's products run, and issue wgmma m64nBNk32 .s32.s8.s8 with A
// from registers and the tap's weights as B. Accumulators s32 in registers
// (BN / 2 a thread); the epilogue writes s32, float32 or bf16 straight from
// them while the producer already loads the next tile's window.
//
// The gather route (conv_int8_kernel), for every other shape (and the 1x1
// kernels whose input ends in a part chunk, where it measured faster): a
// block owns a 128 (output pixels) x 128 (output channels) tile and walks K
// in steps of 64 bytes (one tap, 64 input channels), 8 warps in a 2 x 4
// grid, each warp 64 x 32 of the tile with mma.sync m16n8k32 (s8) and s32
// accumulators in registers. A three-stage cp.async ring holds the A
// (gathered window rows) and B (weight rows) tiles in shared memory, rows
// padded to 80 bytes so that the fragment loads meet no bank conflict; taps
// outside the image are zero-filled by cp.async's source size.
//
// Quantizing a bf16 input inside the tensor-core route instead (producer
// warps staging the bf16 window by TMA and writing codes into the window
// buffer, once per window pixel and output-channel pass) measured slower
// than quantize_kernel followed by the route at every bf16 site: three
// warps could not keep up with the products, and a tile's window repeats
// 1.4x (stage 1) to 8x (stage 3, four passes of BN 192) of its input.
// Which sites take which route, and their times: PERF.md section 6, Q1.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace q1 {
namespace {

// --- the gather route: mma.sync from a cp.async ring --------------------------
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
// The routes (htrvt_conv_int8_route): mma.sync on gathered rows; wgmma fed
// by TMA; for a bf16 input, quantize_kernel into scratch, then wgmma on the
// s8 codes (the gather route, too, runs after quantize_kernel).
enum Route : int { kRouteGather = 0, kRouteWgmma = 1, kRouteQuantizeWgmma = 2 };

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

// --- the bf16 input's quantization (before either route) ----------------------
// y + 1.5 * 2^23 rounds y (|y| <= 127) to an integer, nearest even, and
// holds it in the low bits of its mantissa: the low byte of its bits is
// the s8 code.
constexpr float kRound = 12582912.0f;
// y = a * rsx (rsx = 1 / sx, rounded) lies within 3 * 2^-24 |a / sx| of
// the rounded quotient a / sx (2.3e-5 where |a / sx| <= 128; beyond, both
// clamp), so rint gives the same code unless y is this close to a
// half-integer; those, and NaN, take the true division.
constexpr float kTieSlack = 3e-5f;

// 8 channels of x (one 16-byte load at channel ch) -> 8 s8 codes, with the
// prologue max(T(T(x * s) + t), 0) when kPro (s, t: bf16 values as floats).
template <bool kPro>
__device__ __forceinline__ uint2 quantize8(const uint4* src, const float* __restrict__ sc,
                                           const float* __restrict__ sh, int ch, float sx,
                                           float rsx) {
  const uint4 raw = __ldg(src);
  const uint32_t v[4] = {raw.x, raw.y, raw.z, raw.w};
  float s[8], t[8];
  if (kPro) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float4 s4 = __ldg(reinterpret_cast<const float4*>(sc + ch) + i);
      const float4 t4 = __ldg(reinterpret_cast<const float4*>(sh + ch) + i);
      s[4 * i] = s4.x; s[4 * i + 1] = s4.y; s[4 * i + 2] = s4.z; s[4 * i + 3] = s4.w;
      t[4 * i] = t4.x; t[4 * i + 1] = t4.y; t[4 * i + 2] = t4.z; t[4 * i + 3] = t4.w;
    }
  }
  float a[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v[k]));
    if (kPro) {
      f = __bfloat1622float2(__floats2bfloat162_rn(__fmul_rn(f.x, s[2 * k]),
                                                   __fmul_rn(f.y, s[2 * k + 1])));
      f = __bfloat1622float2(__floats2bfloat162_rn(__fadd_rn(f.x, t[2 * k]),
                                                   __fadd_rn(f.y, t[2 * k + 1])));
      f.x = fmaxf(f.x, 0.0f);
      f.y = fmaxf(f.y, 0.0f);
    }
    a[2 * k] = f.x;
    a[2 * k + 1] = f.y;
  }
  uint32_t c[8];
  bool slow = false;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float y = __fmul_rn(a[e], rsx);
    const float yc = fminf(fmaxf(y, -127.0f), 127.0f);
    const float r = __fadd_rn(yc, kRound);
    slow |= fabsf(__fadd_rn(yc, -__fadd_rn(r, -kRound))) > 0.5f - kTieSlack || isnan(y);
    c[e] = __float_as_uint(r);
  }
  if (slow) {  // rare
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      c[e] = static_cast<uint32_t>(max(-127, min(127, __float2int_rn(__fdiv_rn(a[e], sx)))));
    }
  }
  return make_uint2(
      __byte_perm(__byte_perm(c[0], c[1], 0x0040), __byte_perm(c[2], c[3], 0x0040), 0x5410),
      __byte_perm(__byte_perm(c[4], c[5], 0x0040), __byte_perm(c[6], c[7], 0x0040), 0x5410));
}

// The bf16 input's quantization, once an element: x [rows, C] (C % 16 ==
// 0) -> q [rows, C] s8, 16 channels a thread (two 16-byte loads, one
// store), a grid-stride loop.
template <bool kPro>
__global__ void __launch_bounds__(kThreads) quantize_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ sx,
    const float* __restrict__ pro_scale, const float* __restrict__ pro_shift,
    int8_t* __restrict__ q, long long groups, int C) {
  const float s = __ldg(sx), rs = __frcp_rn(s);
  for (long long g = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       g < groups; g += static_cast<long long>(gridDim.x) * blockDim.x) {
    const uint4* src = reinterpret_cast<const uint4*>(x + g * 16);
    const int ch = static_cast<int>((g * 16) % C);
    const uint2 lo = quantize8<kPro>(src, pro_scale, pro_shift, ch, s, rs);
    const uint2 hi = quantize8<kPro>(src + 1, pro_scale, pro_shift, ch + 8, s, rs);
    reinterpret_cast<uint4*>(q)[g] = make_uint4(lo.x, lo.y, hi.x, hi.y);
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
cudaError_t launch_gather(const Params& p, cudaStream_t stream) {
  auto kernel = conv_int8_kernel<kOut>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.M + kBM - 1) / kBM, p.Co / kBN);
  kernel<<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

// --- the tensor-core route: wgmma fed by TMA ---------------------------------
constexpr int kWgThreads = 384;        // two consumer warpgroups and a producer one
constexpr int kWgConsumerWarps = 8;
constexpr int kTileM = 128;            // output pixels a tile
constexpr int kLine = 128;             // bytes of a window line / weight row: 128 s8 channels
constexpr int kMaxWStages = 6;
constexpr int kMinWStages = 3;
constexpr size_t kSmemMax = 232448;    // a block's dynamic shared memory on the H100
constexpr size_t kWgBars = sizeof(uint64_t) * (4 + 2 * kMaxWStages);

// The tiles of one call and the window a tile reads.
struct WgGeo {
  int th, tw;                  // tile rows and columns: th * tw = kTileM
  int tiles_h, tiles_w, tiles_n;
  long long count;
  int shw, sww;                // window rows / columns between neighbouring outputs
  int win_h, win_w, win_px;
  int halo_stride;             // bytes of a window buffer, a multiple of 1024
  int wstages, chunks;
};

struct WgArgs {
  const float* dq;             // [Co] (float outputs)
  void* y;
  int out;                     // Out
  int Co, Ho, Wo, P;
  WgGeo g;
};

// Tile t's image, first output row, first output column and first output
// channel (channel tiles innermost: neighbouring blocks share a window in L2).
__device__ __forceinline__ void wg_tile(const WgGeo& g, int bn, long long t, int& b, int& h0,
                                        int& w0, int& n0) {
  n0 = static_cast<int>(t % g.tiles_n) * bn;
  t /= g.tiles_n;
  w0 = static_cast<int>(t % g.tiles_w) * g.tw;
  t /= g.tiles_w;
  h0 = static_cast<int>(t % g.tiles_h) * g.th;
  b = static_cast<int>(t / g.tiles_h);
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

template <int kN>
__device__ __forceinline__ void wgmma_s8(int (&d)[kN / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (kN == 256) {
    hopper::wgmma_m64n256k32_s8_rs(d, a, db);
  } else if constexpr (kN == 192) {
    hopper::wgmma_m64n192k32_s8_rs(d, a, db);
  } else {
    hopper::wgmma_m64n128k32_s8_rs(d, a, db);
  }
}

// The epilogue of a consumer warp: accumulator row gq (half 0) or gq + 8 of
// the warp's 16 pixels, columns 8 nt + 2 t4 and + 1.
template <int kOut, int kN>
__device__ __forceinline__ void wg_store(const WgArgs& a, const int (&acc)[kN / 2], int b,
                                         int h0, int w0, int n0, int p0, int lane) {
  const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = p0 + gq + 8 * half;
    const int gh = h0 + p / a.g.tw, gw = w0 + p % a.g.tw;
    if (gh >= a.Ho || gw >= a.Wo) continue;
    const long long row = ((static_cast<long long>(b) * a.Ho + gh) * a.Wo + gw) * a.Co + n0;
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt) {
      const int col = nt * 8 + 2 * t4;
      const int c0 = acc[4 * nt + 2 * half], c1 = acc[4 * nt + 2 * half + 1];
      const long long o = row + col;
      if (kOut == kOutS32) {
        *reinterpret_cast<int2*>(static_cast<int32_t*>(a.y) + o) = make_int2(c0, c1);
      } else if (kOut == kOutF32) {
        const float2 v = make_float2(__fmul_rn(__int2float_rn(c0), __ldg(a.dq + n0 + col)),
                                     __fmul_rn(__int2float_rn(c1), __ldg(a.dq + n0 + col + 1)));
        *reinterpret_cast<float2*>(static_cast<float*>(a.y) + o) = v;
      } else {
        const float v0 =
            __fmul_rn(bf16_round(__int2float_rn(c0)), bf16_round(__ldg(a.dq + n0 + col)));
        const float v1 =
            __fmul_rn(bf16_round(__int2float_rn(c1)), bf16_round(__ldg(a.dq + n0 + col + 1)));
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.y) + o) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// kN output channels a tile, a kK x kK kernel (3, or 1 on a strided view).
// tx maps the s8 input (C, Wv, Hv, B) with a window box of 128 channels, tw
// the packed weight (Ci, KH * KW, Co) with [kN][128] boxes.
template <int kN, int kK>
__global__ void __launch_bounds__(kWgThreads, 1)
conv_int8_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                const WgArgs a) {
  constexpr int kTaps = kK * kK;
  constexpr int kWStage = kN * kLine;
  // registers a thread: setmaxnreg moves registers within the block's
  // launch allocation (168 x 384), so 128 x 40 + 256 x 232 fits; the
  // consumers hold kN / 2 accumulators and two taps' A fragments
  constexpr int kProducerRegs = 40;
  constexpr int kConsumerRegs = 232;
  // the tap after which the TMA thread issues the next chunk's window
  constexpr int kWindowTap = (kTaps < 3 ? kTaps : 3) - 1;
  const WgGeo& g = a.g;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* wring = hopper::align_swizzle(smem_raw);
  unsigned char* halo = wring + g.wstages * kWStage;
  uint64_t* halo_full = reinterpret_cast<uint64_t*>(halo + 2 * g.halo_stride);
  uint64_t* halo_empty = halo_full + 2;
  uint64_t* w_full = halo_empty + 2;
  uint64_t* w_empty = w_full + kMaxWStages;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&halo_full[i], 1);
      hopper::mbar_init(&halo_empty[i], kWgConsumerWarps);
    }
    for (int i = 0; i < g.wstages; ++i) {
      hopper::mbar_init(&w_full[i], 1);
      hopper::mbar_init(&w_empty[i], kWgConsumerWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid == 2 * 128) {
      // TMA: per tile and chunk, the chunk's taps of the weights, and the
      // next chunk's window (this tile's next chunk, or the next tile's
      // first) after the third tap, when the chunk before has released its
      // buffer, so it lands while this chunk's products run.
      hopper::Ring hr(2), wr(g.wstages);
      auto load_window = [&](long long t, int c) {
        int b, h0, w0, n0;
        wg_tile(g, kN, t, b, h0, w0, n0);
        hopper::mbar_wait(&halo_empty[hr.slot], hr.phase ^ 1u);
        hopper::mbar_expect_tx(&halo_full[hr.slot], g.win_px * kLine);
        hopper::tma_load_4d(halo + hr.slot * g.halo_stride, &tx, &halo_full[hr.slot],
                            c * kLine, w0 * g.sww - a.P, h0 * g.shw - a.P, b);
        hr.next();
      };
      load_window(blockIdx.x, 0);
      for (long long t = blockIdx.x; t < g.count; t += gridDim.x) {
        int b, h0, w0, n0;
        wg_tile(g, kN, t, b, h0, w0, n0);
        for (int c = 0; c < g.chunks; ++c) {
#pragma unroll 1
          for (int tap = 0; tap < kTaps; ++tap) {
            hopper::mbar_wait(&w_empty[wr.slot], wr.phase ^ 1u);
            hopper::mbar_expect_tx(&w_full[wr.slot], kWStage);
            hopper::tma_load_3d(wring + wr.slot * kWStage, &tw, &w_full[wr.slot], c * kLine,
                                tap, n0);
            wr.next();
            if (tap == kWindowTap) {
              if (c + 1 < g.chunks) {
                load_window(t, c + 1);
              } else if (t + gridDim.x < g.count) {
                load_window(t + gridDim.x, 0);
              }
            }
          }
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int warp = (tid >> 5) & 3;
    const int p0 = wg * 64 + warp * 16;  // the warp's first pixel of the tile
    // the window pixel (at tap 0) whose address this lane gives ldmatrix
    const int pl = p0 + (lane & 15);
    const int a_px = (pl / g.tw) * g.shw * g.win_w + (pl % g.tw) * g.sww;
    const uint32_t halo_addr = hopper::smem_u32(halo);
    const uint32_t w_addr = hopper::smem_u32(wring);
    hopper::Ring hr(2), wr(g.wstages);
    for (long long t = blockIdx.x; t < g.count; t += gridDim.x) {
      int b, h0, w0, n0;
      wg_tile(g, kN, t, b, h0, w0, n0);
      int acc[kN / 2];
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) acc[i] = 0;
      hopper::fence_regs(acc);
      for (int c = 0; c < g.chunks; ++c) {
        hopper::mbar_wait(&halo_full[hr.slot], hr.phase);
        const uint32_t hbase = halo_addr + hr.slot * g.halo_stride;
        // Tap t's A fragments go to af[t % 2]: they are loaded while tap
        // t - 1's products run, and its weights' stage is released once
        // they are done.
        uint32_t af[2][4][4];
        int pending = -1;
#pragma unroll
        for (int tap = 0; tap < kTaps; ++tap) {
          const int px = a_px + (tap / kK) * g.win_w + tap % kK;
          const uint32_t row = hbase + px * kLine;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            ldsm_x4(af[tap & 1][kk], row + (((kk * 2 + (lane >> 4)) ^ (px & 7)) << 4));
          }
          hopper::mbar_wait(&w_full[wr.slot], wr.phase);
          const uint32_t wbase = w_addr + wr.slot * kWStage;
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_s8<kN>(acc, af[tap & 1][kk], hopper::sw128_desc(wbase + kk * 32));
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();
          if (pending >= 0) {
            __syncwarp();
            if (lane == 0) hopper::mbar_arrive(&w_empty[pending]);
          }
          pending = wr.slot;
          wr.next();
        }
        hopper::wgmma_wait<0>();
        __syncwarp();
        if (lane == 0) {
          hopper::mbar_arrive(&w_empty[pending]);
          hopper::mbar_arrive(&halo_empty[hr.slot]);
        }
        hr.next();
      }
      hopper::fence_regs(acc);
      switch (a.out) {
        case kOutS32: wg_store<kOutS32, kN>(a, acc, b, h0, w0, n0, p0, lane); break;
        case kOutF32: wg_store<kOutF32, kN>(a, acc, b, h0, w0, n0, p0, lane); break;
        default: wg_store<kOutBF16, kN>(a, acc, b, h0, w0, n0, p0, lane); break;
      }
    }
  }
}

int sm_count() {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    sms = 132;
  }
  return sms;
}

// Shared memory of the tensor-core route: the weight ring and two window
// buffers.
size_t wg_smem(const WgGeo& g, int bn) {
  return 1024 + static_cast<size_t>(g.wstages) * bn * kLine +
         2 * static_cast<size_t>(g.halo_stride) + kWgBars;
}

// The tensor-core route's plan for a conv: its tiles, window and weight
// stages, the output channels a tile (bn) and the view strides of the input
// (a 1x1 kernel reads every SH-th row and SW-th column); false where the
// route does not take the shape: kernels other than 3x3 and padding-free
// 1x1, windows past a TMA box or shared memory, and 1x1 kernels whose input
// ends in a part chunk (Ci % 128; the stage-1 entry's projection, where the
// gather route measured faster: PERF.md section 6, Q1).
bool q1_plan(int B, int Ci, int Co, int KH, int KW, int SH, int SW, int P, int Ho, int Wo,
             WgGeo& g, int& bn, int& svh, int& svw) {
  if (KH != KW || (KH != 3 && KH != 1) || (KH == 1 && (P != 0 || Ci % kLine != 0))) {
    return false;
  }
  const int k = KH;
  svh = k == 1 ? SH : 1;
  svw = k == 1 ? SW : 1;
  g.shw = SH / svh;
  g.sww = SW / svw;
  g.th = Ho >= 8 ? 8 : Ho >= 4 ? 4 : Ho >= 2 ? 2 : 1;
  g.tw = kTileM / g.th;
  g.win_h = (g.th - 1) * g.shw + k;
  g.win_w = (g.tw - 1) * g.sww + k;
  if (g.win_h > 256 || g.win_w > 256) return false;  // a TMA box's dims
  g.win_px = g.win_h * g.win_w;
  g.halo_stride = (g.win_px * kLine + 1023) / 1024 * 1024;
  g.wstages = 0;
  const size_t fixed = wg_smem(g, 0);
  if (fixed >= kSmemMax) return false;
  bn = 0;
  for (const int cand : {256, 192, 128}) {
    const int stages = static_cast<int>((kSmemMax - fixed) / (static_cast<size_t>(cand) * kLine));
    if (Co % cand == 0 && stages >= kMinWStages) {
      bn = cand;
      g.wstages = stages < kMaxWStages ? stages : kMaxWStages;
      break;
    }
  }
  if (bn == 0) return false;
  g.tiles_h = (Ho + g.th - 1) / g.th;
  g.tiles_w = (Wo + g.tw - 1) / g.tw;
  g.tiles_n = Co / bn;
  g.count = static_cast<long long>(B) * g.tiles_h * g.tiles_w * g.tiles_n;
  g.chunks = (Ci + kLine - 1) / kLine;
  return true;
}

// The route's kernel for kN output channels a tile and a k x k kernel.
template <int kN>
const void* wg_kernel(int k) {
  return k == 3 ? reinterpret_cast<const void*>(conv_int8_wgmma<kN, 3>)
                : reinterpret_cast<const void*>(conv_int8_wgmma<kN, 1>);
}

// The tensor-core route on s8 codes xq: the maps of the input and the
// weight, then one launch of at most one block per SM.
cudaError_t launch_wgmma(const void* xq, const void* w, const float* dq, void* y, int out,
                         int B, int H, int W, int Ci, int Co, int KH, int KW, int SH, int SW,
                         int P, int Ho, int Wo, cudaStream_t s) {
  WgArgs a;
  int bn, svh, svw;
  if (!q1_plan(B, Ci, Co, KH, KW, SH, SW, P, Ho, Wo, a.g, bn, svh, svw)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = wg_smem(a.g, bn);
  const void* kernel = bn == 256 ? wg_kernel<256>(KH) : bn == 192 ? wg_kernel<192>(KH)
                                                                  : wg_kernel<128>(KH);
  // a runtime call first: cuTensorMapEncodeTiled fails in a thread with no
  // current context
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  CUtensorMap mx, mw;
  const int taps = KH * KW;
  const uint64_t wdims[3] = {static_cast<uint64_t>(Ci), static_cast<uint64_t>(taps),
                             static_cast<uint64_t>(Co)};
  const uint64_t wstrides[2] = {static_cast<uint64_t>(Ci), static_cast<uint64_t>(taps) * Ci};
  const uint32_t wbox[3] = {kLine, 1, static_cast<uint32_t>(bn)};
  const uint64_t xdims[4] = {static_cast<uint64_t>(Ci), static_cast<uint64_t>((W + svw - 1) / svw),
                             static_cast<uint64_t>((H + svh - 1) / svh), static_cast<uint64_t>(B)};
  const uint64_t xstrides[3] = {static_cast<uint64_t>(svw) * Ci,
                                static_cast<uint64_t>(svh) * W * Ci,
                                static_cast<uint64_t>(H) * W * Ci};
  const uint32_t xbox[4] = {kLine, static_cast<uint32_t>(a.g.win_w),
                            static_cast<uint32_t>(a.g.win_h), 1};
  if (!hopper::make_map(&mw, w, 3, wdims, wstrides, wbox, CU_TENSOR_MAP_DATA_TYPE_UINT8) ||
      !hopper::make_map(&mx, xq, 4, xdims, xstrides, xbox, CU_TENSOR_MAP_DATA_TYPE_UINT8)) {
    return cudaErrorInvalidValue;
  }
  a.dq = dq;
  a.y = y;
  a.out = out;
  a.Co = Co; a.Ho = Ho; a.Wo = Wo; a.P = P;
  const int sms = sm_count();
  const dim3 grid(static_cast<unsigned>(a.g.count < sms ? a.g.count : sms));
  void* args[3] = {&mx, &mw, &a};
  err = cudaLaunchKernel(kernel, grid, dim3(kWgThreads), args, smem, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
}  // namespace q1

// The route htrvt_conv_int8 takes for this shape (q1::Route).
extern "C" int htrvt_conv_int8_route(int in_dtype, int B, int Ci, int Co, int KH, int KW,
                                     int SH, int SW, int P, int Ho, int Wo) {
  using namespace q1;
  WgGeo g;
  int bn, svh, svw;
  if (!q1_plan(B, Ci, Co, KH, KW, SH, SW, P, Ho, Wo, g, bn, svh, svw)) return kRouteGather;
  return in_dtype == kInBF16 ? kRouteQuantizeWgmma : kRouteWgmma;
}

extern "C" int htrvt_conv_int8(const void* x, int in_dtype, const void* sx,
                               const void* pro_scale, const void* pro_shift,
                               const void* w, const void* dq, void* y, void* scratch,
                               int out_dtype, int B, int H, int W, int Ci, int Co, int KH,
                               int KW, int SH, int SW, int P, int Ho, int Wo, void* stream) {
  using namespace q1;
  const long long M = static_cast<long long>(B) * Ho * Wo;
  const int route = htrvt_conv_int8_route(in_dtype, B, Ci, Co, KH, KW, SH, SW, P, Ho, Wo);
  if (B <= 0 || H <= 0 || W <= 0 || Ho <= 0 || Wo <= 0 || Ci % kBK || Co % kBN ||
      Ci <= 0 || Co <= 0 || KH <= 0 || KW <= 0 || SH <= 0 || SW <= 0 || P < 0 ||
      M > (1LL << 30) || (out_dtype != kOutS32 && dq == nullptr) ||
      (out_dtype != kOutS32 && out_dtype != kOutF32 && out_dtype != kOutBF16) ||
      (in_dtype != kInS8 && in_dtype != kInBF16) ||
      (in_dtype == kInBF16 && (sx == nullptr || scratch == nullptr)) ||
      ((pro_scale == nullptr) != (pro_shift == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kInBF16) {
    const long long groups = static_cast<long long>(B) * H * W * Ci / 16;
    const long long blocks = std::min<long long>((groups + kThreads - 1) / kThreads, 132LL * 16);
    auto kernel = pro_scale != nullptr ? quantize_kernel<true> : quantize_kernel<false>;
    kernel<<<static_cast<int>(blocks), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(sx),
        static_cast<const float*>(pro_scale), static_cast<const float*>(pro_shift),
        static_cast<int8_t*>(scratch), groups, Ci);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    x = scratch;
  }
  if (route != kRouteGather) {
    return static_cast<int>(launch_wgmma(x, w, static_cast<const float*>(dq), y, out_dtype, B,
                                         H, W, Ci, Co, KH, KW, SH, SW, P, Ho, Wo, s));
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
    case kOutS32: err = launch_gather<kOutS32>(p, s); break;
    case kOutF32: err = launch_gather<kOutF32>(p, s); break;
    default: err = launch_gather<kOutBF16>(p, s); break;
  }
  return static_cast<int>(err);
}
