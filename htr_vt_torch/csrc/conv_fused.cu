// 3x3 convolution (stride 1, zero padding 1) with a fused BatchNorm-apply
// + ReLU prologue, and its two gradients, for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels htr_vt_tpu/ops/conv_fused.py:
// _conv_kernel (:82-127, K4f), _dgrad_kernel (:230-283, K4d) and
// _wgrad_kernel (:286-322, K4w). The plain PyTorch versions with the same
// inputs and outputs are htr_vt_torch/ops/conv_fused.py:
// conv3x3_bn_relu_reference, conv3x3_dgrad_reference and
// conv3x3_wgrad_reference.
//
// Layout: activations [B, H, W, C] (channels-last NCHW tensors), bf16 or
// float32; C % 8 == 0 for every channel count; scale, shift [Cin] float32
// (the folded BN terms). With the prologue on:
//
//   xn  = pad0(T(max(x * scale + shift, 0)))       T = the element type
//   y   = conv3x3(xn, k)                          (K4f, f32 sums -> T)
//   da  = conv3x3(pad0(g), krot)                  (K4d, float32)
//   da' = da where x * scale + shift > 0, else 0  (strict: 0 at a tie)
//   dx  = T(da' * scale), dscale = sum da' * x, dshift = sum da'
//   dk[tap, ci, co] = sum_p xn[p + tap] * g[p]    (K4w, float32)
//
// The pad is applied after the prologue, so halo taps read 0, not
// relu(shift). x * scale + shift and da' * scale round like the plain
// versions (__fmul_rn / __fadd_rn, no FMA contraction). Without the
// prologue xn = x, da' = da and no dscale/dshift are made.
//
// What bounds them on this card: operations. Every stride-1 site of the
// flagship stem at bs 128 does 2 * B*H*W * 9 * C^2 = 347.9 GFLOP per call,
// 0.352 ms at the H100's 989 TFLOP/s (bf16 dense); the bytes (at most
// 403 MB at stage 1, 0.120 ms at 3.35 TB/s) are fewer.
//
// Design. Each kernel is an implicit GEMM that never builds the im2col
// matrix or the normalised tensor in memory.
//   K4f, bf16: M = B*H*W pixels, N = the output channels, K = 9 taps x the
//   input channels. A persistent, warp-specialised wgmma kernel fed by TMA
//   (conv_wgmma, launched as conv_fwd_wgmma below): a block loads a tile of 256
//   output pixels' input with its one-pixel halo, 64 channels at a time; three
//   warps apply the prologue to it once per pixel, a chunk ahead of the
//   products; the nine taps read shifted windows of that one normalised tile
//   into registers (ldmatrix) as the A operand of wgmma, with the tap's weights
//   arriving by TMA as B. The halo and weight buffers are rings with mbarriers,
//   so the next tile's loads overlap this tile's epilogue.
//   K4d, bf16: K4f over g with the rotated kernel and no prologue, plus
//   the dgrad epilogue (conv_dgrad_wgmma below, the same main loop): M =
//   B*H*W pixels, N = the input channels, K = 9 taps x the output
//   channels. The consumers read x at each output pixel for the strict
//   ReLU mask, write dx and reduce da' * x and da' over the tile's pixels
//   in a fixed order into one partial row per pixel tile; the rows are
//   added in a fixed order (sum_row_groups, stem_common.cuh:sum_partials).
//   K4w, bf16: per tap M = the input channels, N = the output channels,
//   K = B*H*W pixels (524,288 deep at stage 1). A warp-specialised wgmma
//   kernel fed by TMA (wgrad_wgmma below), on K4f's pixel tiles: a block
//   owns a 64 x 64 (input x output channel) tile of all nine taps and a
//   split of whole pixel tiles; TMA brings each pixel tile's halo of x and
//   the tile's g, three warps apply the prologue once per halo pixel, and
//   three consumer warpgroups (three taps each) read the taps' shifted
//   windows with ldmatrix.trans as the A operand of wgmma m64n64k16, g as
//   an MN-major B shared by the three. Each split writes its own float32
//   dk and a second pass adds the splits in order.
//   float32 (all three): a 64 x 64 FFMA tile (no TF32).
// The TPU kernels carried dscale/dshift and dk across a sequential batch
// grid; here nothing uses atomics, so two calls give equal bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "stem_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using stem::kVec;

constexpr int kThreads = 256;
constexpr int kWarpRowsFwd = 16;  // a warp's pixels in each of K4f's m64 halves

// float32 FFMA tiles: 16 x 16 threads, 4 x 4 outputs each.
constexpr int kFM = 64, kFN = 64, kFK = 16;

// --- small helpers ---------------------------------------------------------
__device__ __forceinline__ void ldsm_x4_trans_addr(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_addr(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The 128-byte line holding p into L2, asynchronously.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

// Rounds to the element type (nearest even).
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The prologue of 8 channels of a bf16 vector, in registers: x * scale +
// shift rounded twice in float32 (as stem::bn_relu), rounded to bf16 two at
// a time, and the ReLU as a mask of the sign bits (a negative value or -0
// becomes +0).
__device__ __forceinline__ void prologue_vec(uint4& raw, const float sc[kVec],
                                             const float sh[kVec]) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    const __nv_bfloat162 r =
        __floats2bfloat162_rn(__fadd_rn(__fmul_rn(f.x, sc[2 * j]), sh[2 * j]),
                              __fadd_rn(__fmul_rn(f.y, sc[2 * j + 1]), sh[2 * j + 1]));
    const uint32_t u = *reinterpret_cast<const uint32_t*>(&r);
    w[j] = u & ~(((u >> 15) & 0x00010001u) * 0xFFFFu);
  }
}

// The prologue's backward on two neighbouring channels of one pixel: v =
// da where x * scale + shift > 0 (strict), else 0, is added to dt and v * x
// to ds, and v becomes da' * scale.
__device__ __forceinline__ void dgrad_pair(float& v0, float& v1, float2 xv, float s0, float s1,
                                           float h0, float h1, float ds[2], float dt[2]) {
  const float d0 = __fadd_rn(__fmul_rn(xv.x, s0), h0) > 0.f ? v0 : 0.f;
  const float d1 = __fadd_rn(__fmul_rn(xv.y, s1), h1) > 0.f ? v1 : 0.f;
  ds[0] += d0 * xv.x;
  ds[1] += d1 * xv.y;
  dt[0] += d0;
  dt[1] += d1;
  v0 = __fmul_rn(d0, s0);
  v1 = __fmul_rn(d1, s1);
}

// The float32 kernel's epilogue of two neighbouring output channels (col,
// col + 1) of one pixel: the forward stores v; the dgrad epilogue (kBwd)
// masks by the strict ReLU of x * scale + shift, stores da' * scale and
// adds da' * x and da' to the thread's sums.
template <bool kBwd>
__device__ __forceinline__ void epilogue_pair(float v0, float v1, long long off,
                                              int col, const float* __restrict__ ex,
                                              const float* __restrict__ esc,
                                              const float* __restrict__ esh,
                                              float* __restrict__ out, float ds[2],
                                              float dt[2]) {
  if (kBwd) {
    const float2 xv = *reinterpret_cast<const float2*>(ex + off);
    dgrad_pair(v0, v1, xv, esc[col], esc[col + 1], esh[col], esh[col + 1], ds, dt);
  }
  store2(out + off, v0, v1);
}

// --- K4f and K4d, bf16: wgmma fed by TMA ------------------------------------
// A persistent block per SM walks output tiles of 256 pixels (TH image rows x
// TW columns of one image, TH * TW = 256) x 96 output channels, the channels
// innermost so that neighbouring blocks share the input tile in L2. Warpgroup 2
// loads and normalises (its first thread issues TMA, its warps 1-3 run the
// prologue); warpgroups 0 and 1 multiply, each owning 128 of the tile's pixels
// as two m64 halves (224 registers; 56 for warpgroup 2, or 232 and 40 without
// the prologue). Per 64-channel chunk of the input the loader brings the tile's
// halo ((TH + 2) x (TW + 2) pixels x 64 channels, one TMA box, out-of-bounds
// pixels and channels zero-filled) into one of two halo buffers, then the
// chunk's nine taps of the weights ([96 co][64 ci] boxes) into a ring of seven
// stages. The prologue warps apply x * scale + shift, the bf16 cast and the
// ReLU once to each halo pixel inside the image (the zero pad stays zero) while
// the multipliers still work on the chunk before. The multipliers then, for
// each tap, load every warp's A fragments from the halo shifted by the tap with
// ldmatrix (while the previous tap's products run) and issue wgmma m64n96k16
// with A from registers and the tap's weights as B from shared memory. A
// one-pixel shift is no multiple of a core matrix's 8 rows, so a shared-memory
// descriptor cannot address a tap's window of a swizzled tile; ldmatrix takes
// one address a row and can. Accumulators float32, cast once.
// K4d (conv_dgrad_wgmma) runs the same body over g with the rotated
// kernel, and with the mask its epilogue reads x at each output pixel,
// writes dx = T(da' * scale) and sums da' * x and da' per column: over a
// thread's four pixels, over the warp by a fixed butterfly, then over the
// eight consumer warps in order through shared memory, one partial row per
// pixel tile (its channel tiles write disjoint columns of the row).
constexpr int kFwdThreads = 384;
constexpr int kFwdWarps = 8;                       // consumer warps
constexpr int kTilePx = 256;                       // output pixels a tile
constexpr int kTileCo = 96;                        // output channels a tile
constexpr int kChunk = 64;                         // input channels a halo / weight box
constexpr int kHaloRowsMax = 4 * 130;              // (TH + 2)(TW + 2), largest at TH = 2
constexpr int kHaloBytes = kHaloRowsMax * hopper::kSwizzleBytes;  // 66,560
constexpr int kWStage = kTileCo * hopper::kSwizzleBytes;          // 12,288
constexpr int kWStages = 7;
constexpr int kPrologueWarps = 3;                  // warps 1-3 of the producer group
constexpr int kPrologueThreads = 32 * kPrologueWarps;
constexpr size_t kFwdSmem = hopper::kSwizzleAlign + 2 * static_cast<size_t>(kHaloBytes) +
                            kWStages * static_cast<size_t>(kWStage) +
                            sizeof(uint64_t) * (6 + 2 * kWStages);
// K4d's per-warp column sums of da' * x and da': [2][consumer warp][column]
constexpr size_t kRedBytes = sizeof(float) * 2 * kFwdWarps * kTileCo;

// The prologue over one halo buffer of halo_px pixels, halo_w a row: x *
// scale + shift, bf16, ReLU, once per pixel inside the image (halo rows
// [hh_lo, hh_hi), columns [ww_lo, ww_hi); the bounds may pass the halo's)
// for one 8-channel group; the zero-filled pad stays zero. Prologue thread
// pt owns the group pt % 8 of every 12th pixel of the inside, from pt / 8,
// and takes kU of them an iteration (all loads before any store).
template <int kU>
__device__ __forceinline__ void prologue_halo(unsigned char* hb, int halo_px, int halo_w,
                                              int hh_lo, int hh_hi, int ww_lo, int ww_hi,
                                              int pt, const float sc[stem::kVec],
                                              const float sh[stem::kVec]) {
  constexpr int kStep = kPrologueThreads / 8;  // pixels between a thread's vectors
  const int q8 = pt & 7;
  const int rows = (hh_hi < halo_px / halo_w ? hh_hi : halo_px / halo_w) - hh_lo;
  const int cols = (ww_hi < halo_w ? ww_hi : halo_w) - ww_lo;
  const int n = rows * cols;
  if (rows <= 0 || cols <= 0) return;
  int i = pt >> 3;
  int r = i / cols, c = i - r * cols;  // i's row and column in the inside
  while (i < n) {
    uint4 raw[kU];
    uint4* at[kU];
    bool ok[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int px = (hh_lo + r) * halo_w + ww_lo + c;
      ok[u] = i < n;
      at[u] = reinterpret_cast<uint4*>(hb + px * hopper::kSwizzleBytes + ((q8 ^ (px & 7)) << 4));
      raw[u] = ok[u] ? *at[u] : make_uint4(0, 0, 0, 0);
      i += kStep;
      c += kStep;
      while (c >= cols) {
        c -= cols;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      prologue_vec(raw[u], sc, sh);
      if (ok[u]) *at[u] = raw[u];
    }
  }
}

// The tile sizes for an image of H rows: TH = 8, 4 or 2 rows (an image of
// one row takes a tile of two), TW = 256 / TH columns.
__host__ __device__ __forceinline__ int tile_rows(int H) { return H >= 8 ? 8 : H >= 4 ? 4 : 2; }

struct ConvTiles {
  int th, tw, tiles_h, tiles_w, tiles_n;
  long long count;
};

// Tile t's image, first row, first column and first output channel (K4w
// counts its tiles in int: 32-bit divisions).
template <typename Index>
__device__ __forceinline__ void tile_origin(const ConvTiles& g, Index t, int& b, int& h0,
                                            int& w0, int& n0) {
  n0 = static_cast<int>(t % g.tiles_n) * kTileCo;
  t /= g.tiles_n;
  w0 = static_cast<int>(t % g.tiles_w) * g.tw;
  t /= g.tiles_w;
  h0 = static_cast<int>(t % g.tiles_h) * g.th;
  b = static_cast<int>(t / g.tiles_h);
}

// K4d's epilogue inputs: the forward's raw x [P, N], the folded BN terms
// [N], and the partial sums [pixel tiles, 2 N] (dscale's columns, then
// dshift's).
struct DgradEpilogue {
  const bf16* x;
  const float* scale;
  const float* shift;
  float* partial;
};

// The body of K4f (kPro: the prologue on the halo) and K4d (kBwd: the dgrad
// epilogue). tx maps the activation read (x, or g), tw the weights.
template <bool kPro, bool kBwd>
__device__ __forceinline__ void
conv_wgmma(const CUtensorMap* tx, const CUtensorMap* tw, const float* __restrict__ psc,
           const float* __restrict__ psh, bf16* __restrict__ out, int H, int W, int C, int N,
           const ConvTiles& g, const DgradEpilogue& e) {
  // registers a thread: the prologue warps take 56; without them the
  // producer keeps 40 and the consumers take 232 (K4d's x in registers)
  constexpr int kLoaderRegs = kPro ? 56 : 40;
  constexpr int kConsumerRegs = kPro ? 224 : 232;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* halo = hopper::align_swizzle(smem_raw);
  unsigned char* wring = halo + 2 * kHaloBytes;
  uint64_t* halo_full = reinterpret_cast<uint64_t*>(wring + kWStages * kWStage);
  uint64_t* halo_ready = halo_full + 2;
  uint64_t* halo_empty = halo_ready + 2;
  uint64_t* w_full = halo_empty + 2;
  uint64_t* w_empty = w_full + kWStages;
  float (*red)[kFwdWarps][kTileCo] =
      reinterpret_cast<float (*)[kFwdWarps][kTileCo]>(w_empty + kWStages);
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int chunks = (C + kChunk - 1) / kChunk;
  const int halo_w = g.tw + 2;
  const int halo_px = (g.th + 2) * halo_w;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&halo_full[i], 1);
      hopper::mbar_init(&halo_ready[i], kPrologueWarps);
      hopper::mbar_init(&halo_empty[i], kFwdWarps);
    }
    for (int i = 0; i < kWStages; ++i) {
      hopper::mbar_init(&w_full[i], 1);
      hopper::mbar_init(&w_empty[i], kFwdWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    hopper::setmaxnreg_dec<kLoaderRegs>();
    const int pt = tid - 2 * 128 - 32;  // the prologue threads: warps 1-3 of this group
    if (tid == 2 * 128) {
      // TMA: per tile and chunk, the chunk's nine taps, with the next
      // chunk's halo (of this tile or the next) issued after the third tap:
      // its buffer is then being released by the chunk before, so the halo
      // lands, and is normalised, while this chunk's products run.
      hopper::Ring hr(2), wr(kWStages);
      auto load_halo = [&](long long t, int c) {
        int b, h0, w0, n0;
        tile_origin(g, t, b, h0, w0, n0);
        hopper::mbar_wait(&halo_empty[hr.slot], hr.phase ^ 1u);
        hopper::mbar_expect_tx(&halo_full[hr.slot], halo_px * hopper::kSwizzleBytes);
        hopper::tma_load_4d(halo + hr.slot * kHaloBytes, tx, &halo_full[hr.slot],
                            c * kChunk, w0 - 1, h0 - 1, b);
        hr.next();
      };
      if (blockIdx.x < g.count) load_halo(blockIdx.x, 0);
      for (long long t = blockIdx.x; t < g.count; t += gridDim.x) {
        int b, h0, w0, n0;
        tile_origin(g, t, b, h0, w0, n0);
        for (int c = 0; c < chunks; ++c) {
          for (int tap = 0; tap < 9; ++tap) {
            hopper::mbar_wait(&w_empty[wr.slot], wr.phase ^ 1u);
            hopper::mbar_expect_tx(&w_full[wr.slot], kWStage);
            hopper::tma_load_3d(wring + wr.slot * kWStage, tw, &w_full[wr.slot], c * kChunk,
                                n0, tap);
            wr.next();
            if (tap == 2) {
              if (c + 1 < chunks) {
                load_halo(t, c + 1);
              } else if (t + gridDim.x < g.count) {
                load_halo(t + gridDim.x, 0);
              }
            }
          }
        }
      }
    } else if (kPro && pt >= 0) {
      // The prologue, a chunk ahead of the products.
      const int q8 = pt & 7;
      hopper::Ring hr(2);
      for (long long t = blockIdx.x; t < g.count; t += gridDim.x) {
        int b, h0, w0, n0;
        tile_origin(g, t, b, h0, w0, n0);
        // the halo rows and columns inside the image
        const int hh_lo = h0 == 0 ? 1 : 0, hh_hi = H - h0 + 1;
        const int ww_lo = w0 == 0 ? 1 : 0, ww_hi = W - w0 + 1;
        for (int c = 0; c < chunks; ++c) {
          const int ch = c * kChunk + q8 * stem::kVec;
          float sc[stem::kVec], sh[stem::kVec];
          if (ch < C) {  // loaded while the halo is still on its way
            stem::load8(psc + ch, sc);
            stem::load8(psh + ch, sh);
          }
          hopper::mbar_wait(&halo_full[hr.slot], hr.phase);
          if (ch < C) {
            prologue_halo<2>(halo + hr.slot * kHaloBytes, halo_px, halo_w, hh_lo, hh_hi,
                             ww_lo, ww_hi, pt, sc, sh);
          }
          hopper::fence_proxy_async();  // before TMA refills this buffer
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(&halo_ready[hr.slot]);
          hr.next();
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int warp = (tid >> 5) & 3;
    // the tile pixel (its row, column) whose address this lane gives
    // ldmatrix in each m64 half
    int a_row[2], a_col[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int p = wg * 128 + mt * 64 + warp * kWarpRowsFwd + (lane & 15);
      a_row[mt] = p / g.tw;
      a_col[mt] = p % g.tw;
    }
    const uint32_t halo_addr = hopper::smem_u32(halo);
    const uint32_t w_addr = hopper::smem_u32(wring);
    uint64_t* halo_in = kPro ? halo_ready : halo_full;
    hopper::Ring hr(2), wr(kWStages);
    for (long long t = blockIdx.x; t < g.count; t += gridDim.x) {
      int b, h0, w0, n0;
      tile_origin(g, t, b, h0, w0, n0);
      if (kBwd) {
        // x of the tile's pixels into L2 for the epilogue: consumer thread
        // p the 96 channels (192 bytes) of pixel p
        const int gh = h0 + tid / g.tw, gw = w0 + tid % g.tw;
        if (gh < H && gw < W) {
          const bf16* px = e.x + ((static_cast<long long>(b) * H + gh) * W + gw) * N + n0;
          const int last = (N - n0 < kTileCo ? N - n0 : kTileCo) - 1;
          prefetch_l2(px);
          prefetch_l2(px + (last < 64 ? last : 64));
          prefetch_l2(px + last);
        }
      }
      float acc[2][kTileCo / 2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int i = 0; i < kTileCo / 2; ++i) acc[mt][i] = 0.f;
        hopper::fence_regs(acc[mt]);
      }
      for (int c = 0; c < chunks; ++c) {
        hopper::mbar_wait(&halo_in[hr.slot], hr.phase);
        const uint32_t hbase = halo_addr + hr.slot * kHaloBytes;
        // Tap t's A fragments go to af[t % 2]: they are loaded while tap
        // t - 1's products run, and its weights' stage is released once
        // they are done.
        uint32_t af[2][2][4][4];
        int pending = -1;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int dh = tap / 3, dw = tap % 3;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int px = (a_row[mt] + dh) * halo_w + a_col[mt] + dw;
            const uint32_t row_addr = hbase + px * hopper::kSwizzleBytes;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const int chunk16 = kk * 2 + (lane >> 4);
              ldsm_x4_addr(af[tap & 1][mt][kk], row_addr + ((chunk16 ^ (px & 7)) << 4));
            }
          }
          hopper::mbar_wait(&w_full[wr.slot], wr.phase);
          const uint32_t wbase = w_addr + wr.slot * kWStage;
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              hopper::wgmma_m64n96k16_rs(acc[mt], af[tap & 1][mt][kk],
                                         hopper::sw128_desc(wbase + kk * 32), 1);
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
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) hopper::fence_regs(acc[mt]);
      // epilogue: accumulator row g (e < 2) or g + 8 of each warp, columns
      // 8 nt + 2 t and + 1
      const int gq = lane >> 2, t4 = lane & 3;
      if (kBwd) {
        // this thread's four pixels (their index in the batch, or -1 past
        // the image's last row or column: they write and add nothing) and
        // their x at the thread's 24 columns, every load issued before any
        // is used (the tile's x was prefetched into L2)
        int px[2][2];
        uint32_t xr[2][2][kTileCo / 8];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int p = wg * 128 + mt * 64 + warp * kWarpRowsFwd + gq + half * 8;
            const int gh = h0 + p / g.tw, gw = w0 + p % g.tw;
            px[mt][half] = gh < H && gw < W ? (b * H + gh) * W + gw : -1;
            const bf16* xrow = e.x + static_cast<long long>(px[mt][half]) * N;
#pragma unroll
            for (int nt = 0; nt < kTileCo / 8; ++nt) {
              const int col = n0 + nt * 8 + 2 * t4;
              xr[mt][half][nt] = px[mt][half] >= 0 && col < N
                                     ? *reinterpret_cast<const uint32_t*>(xrow + col)
                                     : 0u;
            }
          }
        const int cw = wg * 4 + warp;  // consumer warp 0-7
        hopper::named_barrier_sync(1, 32 * kFwdWarps);  // the last tile's sums are read
#pragma unroll
        for (int nt = 0; nt < kTileCo / 8; ++nt) {
          const int col = n0 + nt * 8 + 2 * t4;
          float ds[2] = {0.f, 0.f}, dt[2] = {0.f, 0.f};
          if (col < N) {
            const float2 sc = make_float2(e.scale[col], e.scale[col + 1]);
            const float2 sh = make_float2(e.shift[col], e.shift[col + 1]);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                if (px[mt][half] >= 0) {
                  float v0 = acc[mt][4 * nt + 2 * half], v1 = acc[mt][4 * nt + 2 * half + 1];
                  dgrad_pair(v0, v1,
                             __bfloat1622float2(
                                 *reinterpret_cast<const __nv_bfloat162*>(&xr[mt][half][nt])),
                             sc.x, sc.y, sh.x, sh.y, ds, dt);
                  store2(out + static_cast<long long>(px[mt][half]) * N + col, v0, v1);
                }
              }
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) {  // over g, a fixed butterfly
              ds[j] += __shfl_xor_sync(0xffffffffu, ds[j], off);
              dt[j] += __shfl_xor_sync(0xffffffffu, dt[j], off);
            }
            if (gq == 0) {
              red[0][cw][nt * 8 + 2 * t4 + j] = ds[j];
              red[1][cw][nt * 8 + 2 * t4 + j] = dt[j];
            }
          }
        }
        hopper::named_barrier_sync(1, 32 * kFwdWarps);  // every warp's sums are in
        if (tid < 2 * kTileCo) {
          const int which = tid / kTileCo, col = tid % kTileCo;
          if (n0 + col < N) {
            float v = 0.f;
#pragma unroll
            for (int w = 0; w < kFwdWarps; ++w) v += red[which][w][col];
            e.partial[(t / g.tiles_n) * 2 * N + which * N + n0 + col] = v;
          }
        }
      } else {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int p = wg * 128 + mt * 64 + warp * kWarpRowsFwd + gq + half * 8;
            const int gh = h0 + p / g.tw, gw = w0 + p % g.tw;
            if (gh >= H || gw >= W) continue;
            bf16* row = out + ((static_cast<long long>(b) * H + gh) * W + gw) * N;
#pragma unroll
            for (int nt = 0; nt < kTileCo / 8; ++nt) {
              const int col = n0 + nt * 8 + 2 * t4;
              if (col < N) {
                store2(row + col, acc[mt][4 * nt + 2 * half], acc[mt][4 * nt + 2 * half + 1]);
              }
            }
          }
      }
    }
  }
}

template <bool kPro>
__global__ void __launch_bounds__(kFwdThreads, 1)
conv_fwd_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
               const float* __restrict__ psc, const float* __restrict__ psh,
               bf16* __restrict__ out, int H, int W, int C, int N, ConvTiles g) {
  conv_wgmma<kPro, false>(&tx, &tw, psc, psh, out, H, W, C, N, g, DgradEpilogue{});
}

// K4d: tg maps g (C = Cout channels), tw the rotated kernel [9, Cin, Cout];
// dx [P, N = Cin]. kMask: the prologue's backward in the epilogue.
template <bool kMask>
__global__ void __launch_bounds__(kFwdThreads, 1)
conv_dgrad_wgmma(const __grid_constant__ CUtensorMap tg, const __grid_constant__ CUtensorMap tw,
                 bf16* __restrict__ dx, int H, int W, int C, int N, ConvTiles g,
                 DgradEpilogue e) {
  conv_wgmma<false, kMask>(&tg, &tw, nullptr, nullptr, dx, H, W, C, N, g, e);
}

// --- K4w, bf16: wgmma fed by TMA --------------------------------------------
// dk[tap, ci, co] = sum over the pixels p of this split of xn[p + tap, ci] *
// g[p, co]: per tap a product with M = 64 input channels, N = 64 output
// channels and K = the pixels. A block owns one 64-channel chunk of the
// input, one 64-channel tile of the output and one split: a run of whole
// pixel tiles (K4f's TH x TW = 256 pixels of one image), so a split never
// ends inside a tile, and pixels of a tile past the image's last row or
// column have g = 0 (TMA's zero fill) and add nothing. Warpgroup 3 loads and
// normalises: its first thread brings each tile's halo of x ((TH + 2) x (TW
// + 2) pixels x the chunk, one TMA box) and the same tile's g ([256 px][64
// co], one box) into rings (three halos where shared memory holds them,
// else two; two g tiles); its warps 1-3 apply the prologue to the halo once
// per pixel (K4f's prologue_halo), ahead of the products.
// Consumer warpgroup dh (0-2) owns the three taps (dh, 0..2): per 16
// pixels it loads each tap's A fragment (channels x pixels) from the halo
// shifted by the tap with ldmatrix.trans, and multiplies by wgmma
// m64n64k16 with A from registers and g as an MN-major B from shared
// memory, the same B for its three taps. 96 float32 accumulators a thread
// (144 registers with the prologue, which takes four vectors at a time in
// 80 in warpgroup 3; 152 without) live over the whole split; each split
// writes its own float32 slab and sum_splits adds them in order. x is read
// once per halo pixel and g once per pixel for each (chunk, tile) pair.
constexpr int kWgradThreads = 512;
constexpr int kWgradWarps = 12;                                    // consumer warps
constexpr int kWgradCo = 64;                                       // output channels a block
constexpr int kGBytes = kTilePx * hopper::kSwizzleBytes;           // 32,768
constexpr long long kMinTilesPerSplit = 4;
constexpr int kMaxHaloSlots = 3;
constexpr size_t kWgradBars = sizeof(uint64_t) * (3 * kMaxHaloSlots + 4);
constexpr size_t kSmemMax = 232448;  // a block's dynamic shared memory on the H100

template <bool kPro>
__global__ void __launch_bounds__(kWgradThreads, 1)
wgrad_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tg,
            const float* __restrict__ psc, const float* __restrict__ psh,
            float* __restrict__ slabs, int H, int W, int Cin, int Cout, ConvTiles g,
            int co_tiles, int tiles_per_split, int halo_slots, int halo_stride) {
  // registers a thread: the prologue's four vectors in flight take 80 in
  // warpgroup 3; without it the consumers take 152
  constexpr int kLoaderRegs = kPro ? 80 : 56;
  constexpr int kConsumerRegs = kPro ? 144 : 152;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* gbuf = hopper::align_swizzle(smem_raw);
  unsigned char* halo = gbuf + 2 * kGBytes;
  uint64_t* halo_full = reinterpret_cast<uint64_t*>(halo + halo_slots * halo_stride);
  uint64_t* halo_ready = halo_full + kMaxHaloSlots;
  uint64_t* halo_empty = halo_ready + kMaxHaloSlots;
  uint64_t* g_full = halo_empty + kMaxHaloSlots;
  uint64_t* g_empty = g_full + 2;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int c0 = static_cast<int>(blockIdx.x / co_tiles) * kChunk;
  const int n0 = static_cast<int>(blockIdx.x % co_tiles) * kWgradCo;
  const int t_begin = static_cast<int>(blockIdx.y) * tiles_per_split;
  const int t_end = t_begin + tiles_per_split < g.count ? t_begin + tiles_per_split
                                                        : static_cast<int>(g.count);
  const int halo_w = g.tw + 2;
  const int halo_px = (g.th + 2) * halo_w;
  if (tid == 0) {
    for (int i = 0; i < halo_slots; ++i) {
      hopper::mbar_init(&halo_full[i], 1);
      hopper::mbar_init(&halo_ready[i], kPrologueWarps);
      hopper::mbar_init(&halo_empty[i], kWgradWarps);
    }
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&g_full[i], 1);
      hopper::mbar_init(&g_empty[i], kWgradWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 3) {
    hopper::setmaxnreg_dec<kLoaderRegs>();
    const int pt = tid - 3 * 128 - 32;  // the prologue threads: warps 1-3 of this group
    if (tid == 3 * 128) {
      hopper::Ring hr(halo_slots), gr(2);
      for (int t = t_begin; t < t_end; ++t) {
        int b, h0, w0, unused;
        tile_origin(g, t, b, h0, w0, unused);
        hopper::mbar_wait(&halo_empty[hr.slot], hr.phase ^ 1u);
        hopper::mbar_expect_tx(&halo_full[hr.slot], halo_px * hopper::kSwizzleBytes);
        hopper::tma_load_4d(halo + hr.slot * halo_stride, &tx, &halo_full[hr.slot], c0, w0 - 1,
                            h0 - 1, b);
        hr.next();
        hopper::mbar_wait(&g_empty[gr.slot], gr.phase ^ 1u);
        hopper::mbar_expect_tx(&g_full[gr.slot], kGBytes);
        hopper::tma_load_4d(gbuf + gr.slot * kGBytes, &tg, &g_full[gr.slot], n0, w0, h0, b);
        gr.next();
      }
    } else if (kPro && pt >= 0) {
      const int ch = c0 + (pt & 7) * stem::kVec;
      float sc[stem::kVec], sh[stem::kVec];
      if (ch < Cin) {
        stem::load8(psc + ch, sc);
        stem::load8(psh + ch, sh);
      }
      hopper::Ring hr(halo_slots);
      for (int t = t_begin; t < t_end; ++t) {
        int b, h0, w0, unused;
        tile_origin(g, t, b, h0, w0, unused);
        hopper::mbar_wait(&halo_full[hr.slot], hr.phase);
        if (ch < Cin) {
          prologue_halo<4>(halo + hr.slot * halo_stride, halo_px, halo_w, h0 == 0 ? 1 : 0,
                           H - h0 + 1, w0 == 0 ? 1 : 0, W - w0 + 1, pt, sc, sh);
        }
        hopper::fence_proxy_async();  // before TMA refills this buffer
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&halo_ready[hr.slot]);
        hr.next();
      }
    }
  } else {
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int warp = (tid >> 5) & 3;
    // This lane gives ldmatrix the row of pixel `lo` of each 16-pixel step
    // (in the tile) and of the channel group `cg` (of the chunk's eight):
    // the four 8 x 8 matrices are (channels 0-7 | 8-15) x (pixels 0-7 |
    // 8-15) of the warp's 16 channels, transposed into the A fragment.
    const int lo = (lane & 7) + ((lane >> 4) << 3);
    const int cg = 2 * warp + ((lane >> 3) & 1);
    const int tw_shift = __ffs(g.tw) - 1;  // TW = 32, 64 or 128
    const uint32_t halo_addr = hopper::smem_u32(halo);
    const uint32_t g_addr = hopper::smem_u32(gbuf);
    uint64_t* halo_in = kPro ? halo_ready : halo_full;
    float acc[3][32];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
      hopper::fence_regs(acc[j]);
    }
    hopper::Ring hr(halo_slots), gr(2);
    for (int t = t_begin; t < t_end; ++t) {
      hopper::mbar_wait(&halo_in[hr.slot], hr.phase);
      hopper::mbar_wait(&g_full[gr.slot], gr.phase);
      const uint32_t hbase = halo_addr + hr.slot * halo_stride;
      const uint32_t gbase = g_addr + gr.slot * kGBytes;
      // Step ks's A fragments go to af[ks % 2]: loaded while step ks - 1's
      // products run. Two steps an iteration: the buffer is fixed in each,
      // and no step's addresses are kept across the loop.
      uint32_t af[2][3][4];
      auto step = [&](int ks, uint32_t (&a)[3][4]) {
        const int p0 = ks * 16;  // 16 pixels of one tile row (TW % 16 == 0)
        const int row0 = ((p0 >> tw_shift) + wg) * halo_w + (p0 & (g.tw - 1)) + lo;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int hp = row0 + j;
          ldsm_x4_trans_addr(a[j], hbase + hp * hopper::kSwizzleBytes + ((cg ^ (hp & 7)) << 4));
        }
        hopper::wgmma_fence();
        const uint64_t db = hopper::sw128_desc(gbase + p0 * hopper::kSwizzleBytes);
#pragma unroll
        for (int j = 0; j < 3; ++j) hopper::wgmma_m64n64k16_rs_tb(acc[j], a[j], db, 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
      };
#pragma unroll 1
      for (int ks = 0; ks < kTilePx / 16; ks += 2) {
        step(ks, af[0]);
        step(ks + 1, af[1]);
      }
      hopper::wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) {
        hopper::mbar_arrive(&halo_empty[hr.slot]);
        hopper::mbar_arrive(&g_empty[gr.slot]);
      }
      hr.next();
      gr.next();
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) hopper::fence_regs(acc[j]);
    // epilogue: accumulator row (input channel) g or g + 8 of the warp's 16,
    // columns (output channels) 8 nt + 2 t and + 1
    float* slab = slabs + static_cast<size_t>(blockIdx.y) * 9 * Cin * Cout;
    const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ci = c0 + warp * 16 + gq + half * 8;
        if (ci >= Cin) continue;
        float* row = slab + (static_cast<size_t>(wg * 3 + j) * Cin + ci) * Cout;
#pragma unroll
        for (int nt = 0; nt < kWgradCo / 8; ++nt) {
          const int co = n0 + nt * 8 + 2 * t4;
          if (co < Cout) store2(row + co, acc[j][4 * nt + 2 * half], acc[j][4 * nt + 2 * half + 1]);
        }
      }
  }
}

// --- K4f / K4d / K4w, float32 FFMA -------------------------------------------
template <bool kPro, bool kBwd>
__global__ void __launch_bounds__(kThreads)
conv_f32_kernel(const float* __restrict__ act, const float* __restrict__ wb,
                const float* __restrict__ psc, const float* __restrict__ psh,
                const float* __restrict__ ex, const float* __restrict__ esc,
                const float* __restrict__ esh, float* __restrict__ out,
                float* __restrict__ partial, int H, int W, int C, int N,
                long long P) {
  __shared__ float As[kFK][kFM + 4];
  __shared__ float Bs[kFK][kFN + 4];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long m0 = static_cast<long long>(blockIdx.x) * kFM;
  const int n0 = blockIdx.y * kFN;
  // Threads 0-127 load A (row tid / 2), 128-255 load B (row tid / 2 - 64);
  // kv picks the 8-channel half of the K step.
  const int lrow = (tid & 127) >> 1, kv = tid & 1;
  const bool loads_a = tid < 128;
  const long long p = m0 + lrow;
  const int pw = static_cast<int>(p % W), ph = static_cast<int>((p / W) % H);
  const int nkc = (C + kFK - 1) / kFK;
  const int steps = 9 * nkc;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < steps; ++s) {
    const int tap = s / nkc;
    const int dh = tap / 3 - 1, dw = tap % 3 - 1;
    const int c = (s - tap * nkc) * kFK + kv * kVec;
    float v[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = 0.f;
    if (loads_a) {
      const int hh = ph + dh, ww = pw + dw;
      if (p < P && c < C && hh >= 0 && hh < H && ww >= 0 && ww < W) {
        stem::load8(act + (p + dh * W + dw) * C + c, v);
        if (kPro) {
          float sc[kVec], sh[kVec];
          stem::load8(psc + c, sc);
          stem::load8(psh + c, sh);
#pragma unroll
          for (int i = 0; i < kVec; ++i) v[i] = stem::bn_relu<float>(v[i], sc[i], sh[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) As[kv * kVec + i][lrow] = v[i];
    } else {
      const int n = n0 + lrow;
      if (n < N && c < C) stem::load8(wb + (static_cast<long long>(tap) * N + n) * C + c, v);
#pragma unroll
      for (int i = 0; i < kVec; ++i) Bs[kv * kVec + i][lrow] = v[i];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[k][ty * 4 + i];
        b[i] = Bs[k][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float ds[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, dt[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + tx * 4 + 2 * j;
      if (row < P && col < N) {
        epilogue_pair<kBwd>(acc[i][2 * j], acc[i][2 * j + 1], row * N + col, col, ex, esc,
                            esh, out, ds[j], dt[j]);
      }
    }
  }
  if (kBwd) {
    __shared__ float red[2][16][kFN];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[0][ty][tx * 4 + j] = ds[j >> 1][j & 1];
      red[1][ty][tx * 4 + j] = dt[j >> 1][j & 1];
    }
    __syncthreads();
    if (tid < kFN && n0 + tid < N) {
      float s = 0.f, d = 0.f;
      for (int y = 0; y < 16; ++y) {
        s += red[0][y][tid];
        d += red[1][y][tid];
      }
      float* row = partial + static_cast<size_t>(blockIdx.x) * 2 * N;
      row[n0 + tid] = s;
      row[N + n0 + tid] = d;
    }
  }
}

template <bool kPro>
__global__ void __launch_bounds__(kThreads)
wgrad_f32_kernel(const float* __restrict__ x, const float* __restrict__ gr,
                 const float* __restrict__ scale, const float* __restrict__ shift,
                 float* __restrict__ out, int H, int W, int Cin, int Cout,
                 long long P, long long k_per_split) {
  __shared__ float As[kFK][kFM + 4];
  __shared__ float Bs[kFK][kFN + 4];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int M = 9 * Cin;
  const int m0 = blockIdx.x * kFM, n0 = blockIdx.y * kFN;
  const long long k_begin = static_cast<long long>(blockIdx.z) * k_per_split;
  const long long k_end = k_begin + k_per_split < P ? k_begin + k_per_split : P;
  // Threads 0-127 load A, 128-255 load B: pixel (tid & 127) / 8 of the step,
  // 8-channel vector tid % 8 of the tile's 64 columns.
  const bool loads_a = tid < 128;
  const int lpix = (tid & 127) >> 3, lv = tid & 7;
  const int r = m0 + lv * kVec;
  const int tap = r / Cin, ci = r - (r / Cin) * Cin;
  const int dh = tap / 3 - 1, dw = tap % 3 - 1;
  const int n = n0 + lv * kVec;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long k0 = k_begin; k0 < k_end; k0 += kFK) {
    const long long p = k0 + lpix;
    float v[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = 0.f;
    if (loads_a) {
      if (r < M && p < k_end) {
        const int w = static_cast<int>(p % W), h = static_cast<int>((p / W) % H);
        if (h + dh >= 0 && h + dh < H && w + dw >= 0 && w + dw < W) {
          stem::load8(x + (p + dh * W + dw) * Cin + ci, v);
          if (kPro) {
            float sc[kVec], sh[kVec];
            stem::load8(scale + ci, sc);
            stem::load8(shift + ci, sh);
#pragma unroll
            for (int i = 0; i < kVec; ++i) v[i] = stem::bn_relu<float>(v[i], sc[i], sh[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) As[lpix][lv * kVec + i] = v[i];
    } else {
      if (n < Cout && p < k_end) stem::load8(gr + p * Cout + n, v);
#pragma unroll
      for (int i = 0; i < kVec; ++i) Bs[lpix][lv * kVec + i] = v[i];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[k][ty * 4 + i];
        b[i] = Bs[k][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* slab = out + static_cast<size_t>(blockIdx.z) * M * Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (row < M && col < Cout) slab[static_cast<size_t>(row) * Cout + col] = acc[i][j];
    }
  }
}

// K4d's block partials [rows, width] are added in two fixed-order passes:
// into kGroups rows of consecutive blocks, then (sum_partials) into one.
constexpr int kGroups = 64;

// groups[g, j] = the sum of partial[r, j] over the rows r of group g, in a
// fixed order: lane y of a (32, 8) block takes every 8th row, and the 8
// lanes are added in order.
__global__ void sum_row_groups(const float* __restrict__ partial, int rows, int width,
                               float* __restrict__ groups) {
  __shared__ float lanes[8][32];
  const int j = blockIdx.x * 32 + threadIdx.x;
  const int g = blockIdx.y;
  const int r0 = static_cast<int>(static_cast<long long>(rows) * g / kGroups);
  const int r1 = static_cast<int>(static_cast<long long>(rows) * (g + 1) / kGroups);
  float acc = 0.f;
  if (j < width) {
    for (int r = r0 + threadIdx.y; r < r1; r += 8) {
      acc += partial[static_cast<size_t>(r) * width + j];
    }
  }
  lanes[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && j < width) {
    float total = 0.f;
#pragma unroll
    for (int y = 0; y < 8; ++y) total += lanes[y][threadIdx.x];
    groups[static_cast<size_t>(g) * width + j] = total;
  }
}

// out[i] = sum over s of partial[s, i], s in order.
__global__ void sum_splits(const float* __restrict__ partial, int splits,
                           long long n, float* __restrict__ out) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += partial[static_cast<size_t>(s) * n + i];
    out[i] = acc;
  }
}

// --- launchers ---------------------------------------------------------------
// Lets `kernel` take `bytes` of dynamic shared memory (over 48 KB needs it).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The float32 FFMA kernel: K4f (pro), K4d (bwd: the dgrad epilogue over
// ex/esc/esh into partial, one row per 64-pixel block) or the bare conv.
cudaError_t launch_conv_f32(const void* act, const void* wb, const float* psc,
                            const float* psh, const void* ex, const float* esc,
                            const float* esh, void* out, float* partial, int B, int H, int W,
                            int C, int N, bool pro, bool bwd, cudaStream_t s) {
  const long long P = static_cast<long long>(B) * H * W;
  const float* a = static_cast<const float*>(act);
  const float* w = static_cast<const float*>(wb);
  const float* e = static_cast<const float*>(ex);
  float* o = static_cast<float*>(out);
  const dim3 grid(static_cast<unsigned>((P + kFM - 1) / kFM), (N + kFN - 1) / kFN);
  if (pro) {
    conv_f32_kernel<true, false><<<grid, kThreads, 0, s>>>(a, w, psc, psh, e, esc, esh, o,
                                                           partial, H, W, C, N, P);
  } else if (bwd) {
    conv_f32_kernel<false, true><<<grid, kThreads, 0, s>>>(a, w, psc, psh, e, esc, esh, o,
                                                           partial, H, W, C, N, P);
  } else {
    conv_f32_kernel<false, false><<<grid, kThreads, 0, s>>>(a, w, psc, psh, e, esc, esh, o,
                                                            partial, H, W, C, N, P);
  }
  return cudaGetLastError();
}

int sm_count() {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    sms = 132;
  }
  return sms;
}

// K4f's and K4w's tiles of B images of H x W pixels, tiles_n channel tiles
// each.
ConvTiles pixel_tiles(int B, int H, int W, int tiles_n) {
  ConvTiles g;
  g.th = tile_rows(H);
  g.tw = kTilePx / g.th;
  g.tiles_h = (H + g.th - 1) / g.th;
  g.tiles_w = (W + g.tw - 1) / g.tw;
  g.tiles_n = tiles_n;
  g.count = static_cast<long long>(B) * g.tiles_h * g.tiles_w * g.tiles_n;
  return g;
}

// A 4-D tensor map (C, W, H, B) of a channels-last bf16 activation with
// boxes of 64 channels x bw columns x bh rows of one image.
bool image_map(CUtensorMap* map, const void* base, int B, int H, int W, int C, int bw, int bh) {
  const size_t e = sizeof(bf16);
  const uint64_t dims[4] = {static_cast<uint64_t>(C), static_cast<uint64_t>(W),
                            static_cast<uint64_t>(H), static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {C * e, static_cast<uint64_t>(W) * C * e,
                               static_cast<uint64_t>(H) * W * C * e};
  const uint32_t box[4] = {kChunk, static_cast<uint32_t>(bw), static_cast<uint32_t>(bh), 1};
  return hopper::make_map(map, base, 4, dims, strides, box);
}

// K4f and K4d in bf16: a 4-D tensor map of the activation read (x, or g;
// C, W, H, B) with a box of the tile's halo, a 3-D one of wb (C, N, 9)
// with [96][64] boxes; a grid of at most one block per SM walks the tiles.
// pro: K4f applies the prologue to x; K4d (dgrad) its backward in the
// epilogue, over e.
cudaError_t launch_conv_wgmma(const void* act, const void* wb, const float* sc,
                              const float* sh, void* out, int B, int H, int W, int C, int N,
                              bool pro, bool dgrad, const DgradEpilogue& e, cudaStream_t s) {
  const ConvTiles g = pixel_tiles(B, H, W, (N + kTileCo - 1) / kTileCo);
  CUtensorMap ma, mw;
  const size_t es = sizeof(bf16);
  const uint64_t wdims[3] = {static_cast<uint64_t>(C), static_cast<uint64_t>(N), 9};
  const uint64_t wstrides[2] = {C * es, static_cast<uint64_t>(N) * C * es};
  const uint32_t wbox[3] = {kChunk, kTileCo, 1};
  if (!image_map(&ma, act, B, H, W, C, g.tw + 2, g.th + 2) ||
      !hopper::make_map(&mw, wb, 3, wdims, wstrides, wbox)) {
    return cudaErrorInvalidValue;
  }
  const int sms = sm_count();
  const unsigned grid = static_cast<unsigned>(g.count < sms ? g.count : sms);
  bf16* o = static_cast<bf16*>(out);
  cudaError_t err;
  if (dgrad) {
    const size_t smem = kFwdSmem + (pro ? kRedBytes : 0);
    auto kernel = pro ? conv_dgrad_wgmma<true> : conv_dgrad_wgmma<false>;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kFwdThreads, smem, s>>>(ma, mw, o, H, W, C, N, g, e);
  } else {
    auto kernel = pro ? conv_fwd_wgmma<true> : conv_fwd_wgmma<false>;
    err = allow_smem(kernel, kFwdSmem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kFwdThreads, kFwdSmem, s>>>(ma, mw, sc, sh, o, H, W, C, N, g);
  }
  return cudaGetLastError();
}

// Adds the split slabs into dk in a fixed order (none to add for one).
cudaError_t add_splits(const float* partial, int splits, int Cin, int Cout, float* dk,
                       cudaStream_t s) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long n = 9LL * Cin * Cout;
  const long long blocks = (n + 255) / 256;
  sum_splits<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      partial, splits, n, dk);
  return cudaGetLastError();
}

// K4w in bf16: K4f's 4-D map of x with the halo box, one of g (Cout, W, H,
// B) with [TH][TW][64] boxes; a block per (input chunk, output tile) pair
// and split.
cudaError_t launch_wgrad_bf16(const void* x, const void* gr, const float* sc, const float* sh,
                              float* dk, float* partial, int B, int H, int W, int Cin,
                              int Cout, int splits, bool pro, cudaStream_t s) {
  const ConvTiles g = pixel_tiles(B, H, W, 1);
  CUtensorMap mx, mg;
  if (!image_map(&mx, x, B, H, W, Cin, g.tw + 2, g.th + 2) ||
      !image_map(&mg, gr, B, H, W, Cout, g.tw, g.th)) {
    return cudaErrorInvalidValue;
  }
  const int co_tiles = (Cout + kWgradCo - 1) / kWgradCo;
  const int chunks = (Cin + kChunk - 1) / kChunk;
  const int per_split = static_cast<int>((g.count + splits - 1) / splits);
  // halo slots 1024-byte aligned, as many as fit (at most three)
  const int halo_stride = ((g.th + 2) * (g.tw + 2) * hopper::kSwizzleBytes +
                           hopper::kSwizzleAlign - 1) / hopper::kSwizzleAlign *
                          hopper::kSwizzleAlign;
  const size_t fixed = hopper::kSwizzleAlign + 2 * static_cast<size_t>(kGBytes) + kWgradBars;
  int slots = static_cast<int>((kSmemMax - fixed) / halo_stride);
  if (slots > kMaxHaloSlots) slots = kMaxHaloSlots;
  const size_t smem = fixed + static_cast<size_t>(slots) * halo_stride;
  auto kernel = pro ? wgrad_wgmma<true> : wgrad_wgmma<false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(chunks * co_tiles, splits), kWgradThreads, smem, s>>>(
      mx, mg, sc, sh, splits == 1 ? dk : partial, H, W, Cin, Cout, g, co_tiles, per_split,
      slots, halo_stride);
  return add_splits(partial, splits, Cin, Cout, dk, s);
}

cudaError_t launch_wgrad_f32(const void* x, const void* g, const float* sc, const float* sh,
                             float* dk, float* partial, int B, int H, int W, int Cin,
                             int Cout, int splits, bool pro, cudaStream_t s) {
  const long long P = static_cast<long long>(B) * H * W;
  const long long ksteps = (P + kFK - 1) / kFK;
  const long long k_per_split = (ksteps + splits - 1) / splits * kFK;
  float* slabs = splits == 1 ? dk : partial;
  const dim3 grid((9 * Cin + kFM - 1) / kFM, (Cout + kFN - 1) / kFN, splits);
  const float* xx = static_cast<const float*>(x);
  const float* gg = static_cast<const float*>(g);
  if (pro) {
    wgrad_f32_kernel<true><<<grid, kThreads, 0, s>>>(xx, gg, sc, sh, slabs, H, W, Cin, Cout, P,
                                                     k_per_split);
  } else {
    wgrad_f32_kernel<false><<<grid, kThreads, 0, s>>>(xx, gg, sc, sh, slabs, H, W, Cin, Cout,
                                                      P, k_per_split);
  }
  return add_splits(partial, splits, Cin, Cout, dk, s);
}

// Pixels are counted in int (K4d's epilogue), so B * H * W < 2^31.
bool bad_shape(int B, int H, int W, int Cin, int Cout) {
  return B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cin % kVec ||
         Cout % kVec || static_cast<long long>(B) * H * W > 0x7fffffffLL;
}

// K4w's split-K: at least two waves of blocks (one block an SM), the count
// of splits up to twice that picked to fill the last wave best, and at
// least 16 K steps (float32) or kMinTilesPerSplit pixel tiles (bf16) a
// split.
constexpr long long kMinStepsPerSplit = 16;
constexpr int kMaxSplits = 64;

}  // namespace

// Pixel tiles of K4d, one partial row each: K4f's tiles in bf16, 64-pixel
// blocks in float32.
static long long dgrad_tiles(int B, int H, int W, int dtype) {
  if (dtype == stem::kBFloat16) return pixel_tiles(B, H, W, 1).count;
  return (static_cast<long long>(B) * H * W + kFM - 1) / kFM;
}

// Rows of the [rows, 2 * Cin] float32 scratch htrvt_conv3x3_dgrad needs:
// one per pixel tile, and kGroups for the first pass over them.
extern "C" long long htrvt_conv3x3_dgrad_rows(int B, int H, int W, int dtype) {
  return dgrad_tiles(B, H, W, dtype) + kGroups;
}

// The number of pixel splits htrvt_conv3x3_wgrad is to be given.
extern "C" int htrvt_conv3x3_wgrad_splits(int B, int H, int W, int Cin, int Cout, int dtype) {
  long long tiles, steps, least_steps;
  if (dtype == stem::kBFloat16) {
    tiles = static_cast<long long>((Cin + kChunk - 1) / kChunk) *
            ((Cout + kWgradCo - 1) / kWgradCo);
    steps = pixel_tiles(B, H, W, 1).count;
    least_steps = kMinTilesPerSplit;
  } else {
    tiles = ((9LL * Cin + kFM - 1) / kFM) * ((Cout + kFN - 1) / kFN);
    steps = (static_cast<long long>(B) * H * W + kFK - 1) / kFK;
    least_steps = kMinStepsPerSplit;
  }
  const int sms = sm_count();
  long long most = steps / least_steps;
  if (most > kMaxSplits) most = kMaxSplits;
  if (most < 1) most = 1;
  const long long least = (2LL * sms + tiles - 1) / tiles;
  long long best = least < most ? least : most;
  double best_fill = 0.0;
  for (long long s = best; s <= 2 * least && s <= most; ++s) {
    const long long blocks = tiles * s;
    const double fill = static_cast<double>(blocks) / (((blocks + sms - 1) / sms) * sms);
    if (fill > best_fill + 1e-9) {
      best_fill = fill;
      best = s;
    }
  }
  return static_cast<int>(best);
}

// K4f. x [B, H, W, Cin] (bf16 if dtype == 1, float32 if 0); wb [9, Cout,
// Cin] in x's dtype, wb[dh * 3 + dw, co, ci] = k[co, ci, dh, dw]; scale,
// shift [Cin] float32, read only when prologue != 0; y [B, H, W, Cout]
// out. Cin and Cout multiples of 8, every pointer 16-byte aligned.
// Returns cudaGetLastError().
extern "C" int htrvt_conv3x3_fwd(const void* x, const void* wb, const void* scale,
                                 const void* shift, void* y, int B, int H, int W,
                                 int Cin, int Cout, int prologue, int dtype,
                                 void* stream) {
  if (bad_shape(B, H, W, Cin, Cout)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const cudaError_t err =
      dtype == stem::kBFloat16
          ? launch_conv_wgmma(x, wb, sc, sh, y, B, H, W, Cin, Cout, prologue != 0, false,
                              DgradEpilogue{}, s)
          : launch_conv_f32(x, wb, sc, sh, nullptr, nullptr, nullptr, y, nullptr, B, H, W,
                            Cin, Cout, prologue != 0, false, s);
  return static_cast<int>(err);
}

// K4d. g [B, H, W, Cout]; wb [9, Cin, Cout], wb[dh * 3 + dw, ci, co] =
// k[co, ci, 2 - dh, 2 - dw] (the rotated kernel); x [B, H, W, Cin] (the
// forward's raw input) and scale, shift [Cin], read only when prologue !=
// 0; dx [B, H, W, Cin] out; with the prologue dscale, dshift [Cin] float32
// out through partial, a float32 scratch of htrvt_conv3x3_dgrad_rows(B, H,
// W, dtype) x 2 * Cin. Returns cudaGetLastError().
extern "C" int htrvt_conv3x3_dgrad(const void* g, const void* wb, const void* x,
                                   const void* scale, const void* shift, void* dx,
                                   void* dscale, void* dshift, void* partial, int B,
                                   int H, int W, int Cin, int Cout, int prologue,
                                   int dtype, void* stream) {
  if (bad_shape(B, H, W, Cin, Cout)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  float* part = static_cast<float*>(partial);
  const bool pro = prologue != 0;
  cudaError_t err =
      dtype == stem::kBFloat16
          ? launch_conv_wgmma(g, wb, nullptr, nullptr, dx, B, H, W, Cout, Cin, pro, true,
                              DgradEpilogue{static_cast<const bf16*>(x), sc, sh, part}, s)
          : launch_conv_f32(g, wb, nullptr, nullptr, x, sc, sh, dx, part, B, H, W, Cout, Cin,
                            false, pro, s);
  if (err != cudaSuccess || !pro) return static_cast<int>(err);
  const int rows = static_cast<int>(dgrad_tiles(B, H, W, dtype));
  const float* last = part;
  int last_rows = rows;
  if (rows > kGroups) {
    float* groups = part + static_cast<size_t>(rows) * 2 * Cin;
    const dim3 grid((2 * Cin + 31) / 32, kGroups);
    sum_row_groups<<<grid, dim3(32, 8), 0, s>>>(part, rows, 2 * Cin, groups);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    last = groups;
    last_rows = kGroups;
  }
  err = stem::launch_sum_partials(last, last_rows, Cin, static_cast<float*>(dscale),
                                  static_cast<float*>(dshift), s);
  return static_cast<int>(err);
}

// K4w. x [B, H, W, Cin] (raw), g [B, H, W, Cout], scale, shift [Cin] read
// only when prologue != 0; dk [9, Cin, Cout] float32 out, dk[dh * 3 + dw,
// ci, co]; the pixels are cut into `splits` parts, and for splits > 1
// partial is a float32 scratch of splits x 9 * Cin * Cout. Returns
// cudaGetLastError().
extern "C" int htrvt_conv3x3_wgrad(const void* x, const void* g, const void* scale,
                                   const void* shift, void* dk, void* partial, int B,
                                   int H, int W, int Cin, int Cout, int splits,
                                   int prologue, int dtype, void* stream) {
  if (bad_shape(B, H, W, Cin, Cout) || splits <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  float* out = static_cast<float*>(dk);
  float* part = static_cast<float*>(partial);
  const cudaError_t err =
      dtype == stem::kBFloat16
          ? launch_wgrad_bf16(x, g, sc, sh, out, part, B, H, W, Cin, Cout, splits,
                              prologue != 0, s)
          : launch_wgrad_f32(x, g, sc, sh, out, part, B, H, W, Cin, Cout, splits,
                             prologue != 0, s);
  return static_cast<int>(err);
}
