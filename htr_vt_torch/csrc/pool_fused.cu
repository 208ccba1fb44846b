// BatchNorm-apply + ReLU + 3x3/(2,1) max-pool, forward and backward, for
// Hopper, sm_90a: shared-memory tiles fed by the Tensor Memory Accelerator.
//
// Replaces the Pallas TPU kernels htr_vt_tpu/ops/pool_fused.py:
// _pool_fwd_kernel (:62-69, launched by _pool_fwd_local :159-176) and
// _pool_bwd_kernel (:72-149, launched by _pool_bwd_local :179-206). The
// plain PyTorch versions with the same inputs and outputs are
// htr_vt_torch/ops/pool_fused.py:max_pool_bn_relu_reference and
// pool_bn_relu_bwd_reference.
//
// Layout: x [B, H, W, C] (a channels-last NCHW tensor), H even, C % 8 == 0,
// bf16 or float32; scale, shift [C] float32 (the folded BN terms); y
// [B, H/2, W, C]; g [B, H/2, W, C], or [B, C, H/2, W] (contiguous NCHW,
// the layout the stem's backward hands the pool, W * itemsize % 16 == 0).
//
//   a[b,h,w,c]  = max(T(x * scale + shift), 0)      T = the element type
//   y[b,ho,w,c] = max over kh, kw in 0..2 of a[b, 2ho-1+kh, w-1+kw, c]
//                 (-inf outside the image)
//
// Backward: each window's gradient goes to its first maximal tap in scan
// order (kh, kw row-major), as XLA's select-and-scatter routes it. An input
// element gathers, tap by tap in scan order, the gradient of every window
// whose argmax it is, adding in the element type (the TPU kernel's
// da_even/da_odd accumulators). Then, in float32:
//   da' = da if a_pre > 0, 0 if a_pre < 0, da / 2 at a_pre == 0
//   (jnp.maximum's gradient at a tie), a_pre = x * scale + shift
//   dx = T(da' * scale), dscale = sum da' * x, dshift = sum da'.
// x * scale + shift and da' * scale round like the eager twin (__fmul_rn /
// __fadd_rn, no FMA contraction), so y and dx are bit-equal to it.
//
// What bounds them on this card: memory. The forward reads x once and
// writes y (805.3 + 402.7 MB at the stem's [128, 192, 32, 512] bf16 entry:
// 0.361 ms at 3.35 TB/s); the backward reads g and x and writes dx
// (402.7 + 805.3 + 805.3 MB: 0.601 ms).
//
// Design. A tile is one image, a band of window rows, a strip of columns
// and a chunk of channels 128 bytes wide (64 bf16 or 32 float32): one TMA
// load of a 4-D box of x (dims C, W, H, B) lands it in shared memory with
// the 128-byte swizzle (16-byte chunk k of pixel line i at k ^ (i % 8)), so
// that every pass below reads and writes whole lines without bank
// conflicts. A thread always works on the same 16-byte chunk of a line (8
// bf16 or 4 float32 channels), so its scale and shift stay in registers.
//
// K3f (pool_fwd_kernel): a band of kFwdBand = 8 window rows and a strip of
// kFwdStrip = 32 columns; the box holds x rows 2ho0-1 .. 2ho0+15 and
// columns w0-1 .. w0+32 (17 x 34 lines, 74.0 KB: three blocks a SM). A
// thread per (column, chunk) walks down its column, normalises each
// element once and writes the max over the 3 rows of each window (stride
// 2) back over the row it no longer needs; then a thread per output takes
// the max over 3 of those columns and stores y with 16-byte stores. Taps
// outside the image are set to 0 by their coordinates (the box's zero fill
// is x = 0, whose normalised value is relu(shift)): every a is >= 0 and
// every window has a tap in the image, so a 0 never changes the max. Extra
// bytes: one x row a band above (shared with the band above; the first
// band's is fill) and 2 columns a strip: at H = 32, 33 of 32 rows and 34 of
// 32 columns, 9.6% more reads of x, from L2 where neighbouring tiles run
// together.
//
// K3b (pool_bwd_kernel): a band of kBwdBand = 8 window rows (input rows
// 2ho0 .. 2ho0+15) and a strip of kBwdStrip = 16 columns. The x box holds
// the rows and columns that the argmax of every window reaching the tile
// needs: windows ho0 .. ho0+8 (the band's and the next band's first) and
// w0-1 .. w0+16, so x rows 2ho0-1 .. 2ho0+17 and columns w0-2 .. w0+17 (19
// x 20 lines, 47.5 KB); the g box holds those windows (9 x 18 lines; an
// NCHW g's box starts 16 bytes left of the strip, as TMA needs of an
// unswizzled map's innermost coordinate). A persistent grid of one block a
// SM (512 threads) walks the tiles of one channel chunk; the next tile's
// boxes load into a second buffer while this one is worked on:
//   0. TMA: x and g (an NCHW g lands as [channel][row][column] and is
//      transposed into the swizzled channels-last lines);
//   1. each thread keeps the raw x of its 4 owned chunks in registers, then
//      the tile is normalised in place, once an element; taps outside the
//      image get -inf by their coordinates. The box's zero fill cannot
//      stand in: a ReLU'd 0 inside a window ties with a filled 0, and the
//      earlier tap in scan order would take the gradient;
//   2. each window's argmax, once: the first maximal tap in scan order,
//      kept as the tap's index in a lane of the element type a channel
//      (packed bf16x2 max and equality, the taps in reverse scan order so
//      that the first equal one stays); windows outside the image claim
//      nothing;
//   3. each owned element gathers its routed gradient from shared memory
//      in tap scan order, adding in the element type (packed bf16x2 adds
//      of g masked by the claim), applies the ReLU backward and stores dx;
//      da' * x and da' go to per-thread float32 sums.
// The sums go through per-block partials (one row per group of chunk
// blocks) and the fixed-order stem::launch_sum_partials: no atomics, so two
// calls give equal bits. Extra bytes at H = 32: 35 of 32 x rows and 20 of
// 16 columns (1.37x x), 17 of 16 window rows and 18 of 16 columns of g
// (1.2x), from L2 where neighbouring tiles run together. Where its time
// goes on the card: python -m htr_vt_torch.cli.pool_breakdown (PERF.md).

#include <math_constants.h>

#include "hopper.cuh"
#include "stem_common.cuh"

namespace {

constexpr int kLine = 128;               // bytes of a pixel's channel chunk
constexpr int kChunks = kLine / 16;      // 16-byte chunks a line

// K3f
constexpr int kFwdBand = 8;                         // window rows a tile
constexpr int kFwdStrip = 32;                       // columns a tile
constexpr int kFwdRows = 2 * kFwdBand + 1;          // x rows 2ho0-1 .. 2ho0+2*band-1
constexpr int kFwdCols = kFwdStrip + 2;             // x columns w0-1 .. w0+strip
constexpr int kFwdThreads = kFwdCols * kChunks;     // 272: a (column, chunk) each
constexpr int kFwdTile = kFwdRows * kFwdCols * kLine;  // 73,984 bytes
constexpr int kFwdSmem = hopper::kSwizzleAlign + kFwdTile + 16;

// K3b
constexpr int kBwdBand = 8;                         // window rows a tile
constexpr int kBwdStrip = 16;                       // columns a tile
constexpr int kBwdXRows = 2 * kBwdBand + 3;         // x rows 2ho0-1 .. 2ho0+2*band+1
constexpr int kBwdXCols = kBwdStrip + 4;            // x columns w0-2 .. w0+strip+1
constexpr int kBwdGRows = kBwdBand + 1;             // windows ho0 .. ho0+band
constexpr int kBwdGCols = kBwdStrip + 2;            // windows w0-1 .. w0+strip
constexpr int kBwdWindows = kBwdGRows * kBwdGCols;  // 162 window lines
constexpr int kBwdThreads = 512;
constexpr int kBwdPixelsPerRound = kBwdThreads / kChunks;  // 64
constexpr int kBwdOwned = 2 * kBwdBand * kBwdStrip / kBwdPixelsPerRound;  // 4 a thread

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }
constexpr int kBwdXBytes = round_up(kBwdXRows * kBwdXCols * kLine, hopper::kSwizzleAlign);
constexpr int kBwdGBytes = round_up(kBwdWindows * kLine, hopper::kSwizzleAlign);

static_assert(kFwdThreads % kChunks == 0 && kBwdThreads % kChunks == 0,
              "a thread keeps one chunk in every pass");
static_assert(kBwdPixelsPerRound % kBwdStrip == 0 || kBwdStrip % kBwdPixelsPerRound == 0,
              "owned pixels tile the strip");

// The channels of one 16-byte chunk, their bits and their tensor-map type.
template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  using Bits = unsigned short;
  static constexpr int kN = 8;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Elem<float> {
  using Bits = unsigned int;
  static constexpr int kN = 4;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

// The NCHW box starts nchw_pad() columns (16 bytes) left of the strip, so
// that its first column lies on a 16-byte boundary as TMA needs of an
// unswizzled map's innermost coordinate (w0 is a multiple of 16), and its
// rows, a multiple of 16 bytes, reach the strip's last window.
template <typename T>
__host__ __device__ constexpr int nchw_pad() {
  return 16 / static_cast<int>(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int nchw_box_cols() {
  return round_up(nchw_pad<T>() + kBwdGCols - 1, nchw_pad<T>());
}
template <typename T>
__host__ __device__ constexpr int nchw_bytes() {
  return Elem<T>::kN * kChunks * kBwdGRows * nchw_box_cols<T>() * static_cast<int>(sizeof(T));
}
// One of K3b's two g buffers: TMA's box of g, channels-last (swizzled
// lines) or NCHW.
template <typename T, bool kNchw>
__host__ __device__ constexpr int bwd_g_buffer() {
  return kNchw ? round_up(nchw_bytes<T>(), hopper::kSwizzleAlign) : kBwdGBytes;
}
template <typename T, bool kNchw>
__host__ __device__ constexpr int bwd_smem() {  // + 16: the two barriers
  return hopper::kSwizzleAlign + 2 * kBwdXBytes + 2 * bwd_g_buffer<T, kNchw>() + kBwdGBytes +
         16;
}

// K3b's tile t: chunk fastest, then strip, band and image.
struct BwdTile {
  int w0, ho0, b;
};
__host__ __device__ inline BwdTile bwd_tile(long long t, int n_chunks, int n_strips,
                                            int n_bands) {
  BwdTile r;
  t /= n_chunks;
  r.w0 = static_cast<int>(t % n_strips) * kBwdStrip;
  t /= n_strips;
  r.ho0 = static_cast<int>(t % n_bands) * kBwdBand;
  r.b = static_cast<int>(t / n_bands);
  return r;
}

// K3b's boxes of tile n, chunk c0: x and g, with the bytes they bring.
template <typename T, bool kNchw>
__device__ __forceinline__ void bwd_load(const CUtensorMap* tx, const CUtensorMap* tg,
                                         uint64_t* bar, unsigned char* xdst,
                                         unsigned char* gdst, int c0, const BwdTile& n) {
  hopper::mbar_expect_tx(bar, kBwdXRows * kBwdXCols * kLine +
                                  (kNchw ? nchw_bytes<T>() : kBwdWindows * kLine));
  hopper::tma_load_4d(xdst, tx, bar, c0, n.w0 - 2, 2 * n.ho0 - 1, n.b);
  if (kNchw) {
    hopper::tma_load_4d(gdst, tg, bar, n.w0 - nchw_pad<T>(), n.ho0, c0, n.b);
  } else {
    hopper::tma_load_4d(gdst, tg, bar, c0, n.w0 - 1, n.ho0, n.b);
  }
}

// Byte offset of chunk k of line i in a 128-byte-swizzled buffer.
__device__ __forceinline__ int swz(int line, int k) {
  return line * kLine + ((k ^ (line & 7)) << 4);
}

__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}
// To the element type, rounding to nearest even (exact for values that are
// representable).
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return raw;
}
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}

__device__ __forceinline__ uint4 lds(const unsigned char* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void sts(unsigned char* p, const uint4& v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// scale/shift of the kN channels from c (zeros for a chunk past C).
template <int kN>
__device__ __forceinline__ void load_terms(const float* __restrict__ scale,
                                           const float* __restrict__ shift, int c, bool live,
                                           float (&sc)[kN], float (&sh)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; i += 4) {
    const float4 a = live ? *reinterpret_cast<const float4*>(scale + c + i)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 b = live ? *reinterpret_cast<const float4*>(shift + c + i)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    sc[i] = a.x; sc[i + 1] = a.y; sc[i + 2] = a.z; sc[i + 3] = a.w;
    sh[i] = b.x; sh[i + 1] = b.y; sh[i + 2] = b.z; sh[i + 3] = b.w;
  }
}

// The normalised chunk k of line `line` of x's tile, or `outside` for
// every channel when the pixel lies outside the image.
template <typename T, int kN>
__device__ __forceinline__ void bn_relu_chunk(const unsigned char* tile, int line, int k,
                                              bool inside, float outside,
                                              const float (&sc)[kN], const float (&sh)[kN],
                                              float (&a)[kN]) {
  unpack(lds(tile + swz(line, k)), a);
#pragma unroll
  for (int i = 0; i < kN; ++i) a[i] = inside ? stem::bn_relu<T>(a[i], sc[i], sh[i]) : outside;
}

template <typename T>
__device__ __forceinline__ void store_chunk(T* p, const uint4& v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// Lane-wise operations on a 32-bit word of a chunk: two bf16 or one
// float32. Max and equality are exact; the add rounds once to nearest
// even, which for two values of the element type is the float32 add
// rounded to the element type (the sum of two bf16 needs at most 24
// significant bits unless one is below the other's half ulp).
__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
template <typename T>
__device__ __forceinline__ uint32_t lane_max(uint32_t a, uint32_t b) {
  if constexpr (sizeof(T) == 2) {
    return as_u32(__hmax2(as_bf162(a), as_bf162(b)));
  } else {
    return __float_as_uint(fmaxf(__uint_as_float(a), __uint_as_float(b)));
  }
}
// All ones in the lanes where a == b.
template <typename T>
__device__ __forceinline__ uint32_t lane_eq(uint32_t a, uint32_t b) {
  if constexpr (sizeof(T) == 2) {
    return __heq2_mask(as_bf162(a), as_bf162(b));
  } else {
    return __uint_as_float(a) == __uint_as_float(b) ? 0xffffffffu : 0u;
  }
}
template <typename T>
__device__ __forceinline__ uint32_t lane_add(uint32_t a, uint32_t b) {
  if constexpr (sizeof(T) == 2) {
    return as_u32(__hadd2(as_bf162(a), as_bf162(b)));
  } else {
    return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
  }
}
// The small integer v in every lane of a word, as the element type.
template <typename T>
__device__ __forceinline__ uint32_t lane_int(int v) {
  const uint32_t f = __float_as_uint(static_cast<float>(v));
  return sizeof(T) == 2 ? (f >> 16) | (f & 0xffff0000u) : f;
}
__device__ __forceinline__ uint32_t* words(uint4& v) { return reinterpret_cast<uint32_t*>(&v); }

// ---------------------------------------------------------------------------
// K3f: one tile a block.
template <typename T>
__global__ void __launch_bounds__(kFwdThreads, 3)
pool_fwd_kernel(const __grid_constant__ CUtensorMap tx, const float* __restrict__ scale,
                const float* __restrict__ shift, T* __restrict__ y, int H, int W, int C,
                int n_chunks, int n_strips, int n_bands) {
  constexpr int kN = Elem<T>::kN;
  constexpr int kCc = kChunks * kN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* tile = hopper::align_swizzle(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(tile + kFwdTile);

  long long t = blockIdx.x;
  const int chunk = static_cast<int>(t % n_chunks);
  t /= n_chunks;
  const int w0 = static_cast<int>(t % n_strips) * kFwdStrip;
  t /= n_strips;
  const int ho0 = static_cast<int>(t % n_bands) * kFwdBand;
  const int b = static_cast<int>(t / n_bands);
  const int Ho = H / 2;
  const int tid = threadIdx.x;

  if (tid == 0) {
    hopper::mbar_init(bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(bar, kFwdTile);
    hopper::tma_load_4d(tile, &tx, bar, chunk * kCc, w0 - 1, 2 * ho0 - 1, b);
  }
  const int k = tid % kChunks;
  const int c = chunk * kCc + k * kN;
  const bool live = c < C;
  float sc[kN], sh[kN];
  load_terms<kN>(scale, shift, c, live, sc, sh);
  hopper::mbar_wait(bar, 0);

  {  // Rows: column j of the tile, x column w0 - 1 + j, top to bottom.
    const int j = tid / kChunks;
    const int wi = w0 - 1 + j;
    const bool col_in = wi >= 0 && wi < W;
    float prev[kN];
    bn_relu_chunk<T>(tile, j, k, col_in && ho0 > 0, 0.f, sc, sh, prev);
#pragma unroll 2
    for (int r = 0; r < kFwdBand; ++r) {
      const int h = 2 * (ho0 + r);  // tile rows 2r + 1, 2r + 2: x rows h, h + 1
      float a1[kN], a2[kN], m[kN];
      bn_relu_chunk<T>(tile, (2 * r + 1) * kFwdCols + j, k, col_in && h < H, 0.f, sc, sh, a1);
      bn_relu_chunk<T>(tile, (2 * r + 2) * kFwdCols + j, k, col_in && h + 1 < H, 0.f, sc, sh,
                       a2);
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        m[i] = fmaxf(prev[i], fmaxf(a1[i], a2[i]));
        prev[i] = a2[i];
      }
      // tile row 2r (window r's top row) is read by no one after this
      sts(tile + swz(2 * r * kFwdCols + j, k), pack(m));
    }
  }
  __syncthreads();

  // Columns: output (r, w) is the max of row maxima w, w + 1, w + 2.
  if (!live) return;
  for (int p = tid / kChunks; p < kFwdBand * kFwdStrip; p += kFwdThreads / kChunks) {
    const int r = p / kFwdStrip;
    const int w = p - r * kFwdStrip;
    const int ho = ho0 + r;
    const int wo = w0 + w;
    if (ho >= Ho || wo >= W) continue;
    const int line = 2 * r * kFwdCols + w;
    float m[kN], v[kN];
    unpack(lds(tile + swz(line, k)), m);
#pragma unroll
    for (int d = 1; d < 3; ++d) {
      unpack(lds(tile + swz(line + d, k)), v);
#pragma unroll
      for (int i = 0; i < kN; ++i) m[i] = fmaxf(m[i], v[i]);
    }
    store_chunk(y + ((static_cast<long long>(b) * Ho + ho) * W + wo) * C + c, pack(m));
  }
}

// ---------------------------------------------------------------------------
// K3b: a persistent grid of a block a SM; block i takes chunk i % n_chunks
// of every tile i, i + grid, ... (the grid is a multiple of n_chunks), so
// the blocks running together sweep the image in order. Two buffers: the
// next tile's TMA runs while this one is worked on.
template <typename T, bool kNchw>
__global__ void __launch_bounds__(kBwdThreads, 1)
pool_bwd_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tg,
                const float* __restrict__ scale, const float* __restrict__ shift,
                T* __restrict__ dx, float* __restrict__ partial, int H, int W, int C,
                int n_chunks, int n_strips, int n_bands, long long n_tiles) {
  constexpr int kN = Elem<T>::kN;
  constexpr int kCc = kChunks * kN;
  constexpr int kGBuf = bwd_g_buffer<T, kNchw>();
  constexpr int kNchwCols = nchw_box_cols<T>();
  const uint32_t kNoneLanes = lane_int<T>(15);  // no window: matches no tap
  const uint32_t kNegInf = sizeof(T) == 2 ? 0xff80ff80u : 0xff800000u;  // -inf lanes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // x[2] | g[2] (TMA's) | the swizzled g lines (NCHW) or the argmax lanes
  // (channels-last; an NCHW tile's lanes reuse its g buffer) | barriers[2]
  unsigned char* xbuf = hopper::align_swizzle(smem_raw);
  unsigned char* gbuf = xbuf + 2 * kBwdXBytes;
  unsigned char* third = gbuf + 2 * kGBuf;
  uint64_t* bars = reinterpret_cast<uint64_t*>(third + kBwdGBytes);

  const int Ho = H / 2;
  const int tid = threadIdx.x;
  const int k = tid % kChunks;
  const int slot = tid / kChunks;
  const int c0 = static_cast<int>(blockIdx.x % n_chunks) * kCc;
  const int c = c0 + k * kN;
  const bool live = c < C;
  float sc[kN], sh[kN], ds[kN], dt[kN];
  load_terms<kN>(scale, shift, c, live, sc, sh);
#pragma unroll
  for (int i = 0; i < kN; ++i) ds[i] = dt[i] = 0.f;

  if (tid == 0) {
    hopper::mbar_init(&bars[0], 1);
    hopper::mbar_init(&bars[1], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && blockIdx.x < n_tiles) {  // the first tile's boxes into buffer 0
    bwd_load<T, kNchw>(&tx, &tg, &bars[0], xbuf, gbuf, c0,
                       bwd_tile(blockIdx.x, n_chunks, n_strips, n_bands));
  }

  int it = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    const int s = it & 1;
    const BwdTile tile = bwd_tile(t, n_chunks, n_strips, n_bands);
    const int w0 = tile.w0, ho0 = tile.ho0, b = tile.b;
    // the next tile's boxes into buffer s ^ 1, freed by the last tile's
    // closing barrier
    if (tid == 0 && t + gridDim.x < n_tiles) {
      bwd_load<T, kNchw>(&tx, &tg, &bars[s ^ 1], xbuf + (s ^ 1) * kBwdXBytes,
                         gbuf + (s ^ 1) * kGBuf, c0,
                         bwd_tile(t + gridDim.x, n_chunks, n_strips, n_bands));
    }
    hopper::mbar_wait(&bars[s], (it >> 1) & 1);
    unsigned char* xs = xbuf + s * kBwdXBytes;
    unsigned char* gs = kNchw ? third : gbuf + s * kGBuf;
    unsigned char* args = kNchw ? gbuf + s * kGBuf : third;

    if (kNchw) {  // [channel][window row][column] -> swizzled lines of g
      using Bits = typename Elem<T>::Bits;
      const Bits* gn = reinterpret_cast<const Bits*>(gbuf + s * kGBuf);
      for (int e = tid; e < kBwdWindows * kChunks; e += kBwdThreads) {
        const int kk = e / kBwdWindows;
        const int line = e - kk * kBwdWindows;
        const int r = line / kBwdGCols;
        const int j = line - r * kBwdGCols;
        union {
          uint4 raw;
          Bits v[kN];
        } chunk;
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          chunk.v[i] = gn[((kk * kN + i) * kBwdGRows + r) * kNchwCols + j + nchw_pad<T>() - 1];
        }
        sts(gs + swz(line, kk), chunk.raw);
      }
    }

    // 1. The owned pixels' raw x into registers, then the tile normalised
    // in place: -inf outside the image.
    uint4 xr[kBwdOwned];
#pragma unroll
    for (int o = 0; o < kBwdOwned; ++o) {
      const int q = slot + o * kBwdPixelsPerRound;
      const int hr = q / kBwdStrip;
      const int wr = q - hr * kBwdStrip;
      xr[o] = lds(xs + swz((hr + 1) * kBwdXCols + wr + 2, k));
    }
    __syncthreads();
    for (int line = slot; line < kBwdXRows * kBwdXCols; line += kBwdPixelsPerRound) {
      const int row = line / kBwdXCols;
      const int col = line - row * kBwdXCols;
      const int h = 2 * ho0 - 1 + row;
      const int wi = w0 - 2 + col;
      uint4 v = make_uint4(kNegInf, kNegInf, kNegInf, kNegInf);
      if (h >= 0 && h < H && wi >= 0 && wi < W) {
        float a[kN];
        unpack(lds(xs + swz(line, k)), a);
#pragma unroll
        for (int i = 0; i < kN; ++i) a[i] = __fadd_rn(__fmul_rn(a[i], sc[i]), sh[i]);
        v = pack(a);
        // The ReLU in the element type. Its zero may carry a sign here,
        // which no max or equality below can see.
#pragma unroll
        for (int wd = 0; wd < 4; ++wd) words(v)[wd] = lane_max<T>(words(v)[wd], 0u);
      }
      sts(xs + swz(line, k), v);
    }
    __syncthreads();

    // 2. Each window's first maximal tap, a lane of the element type a
    // channel: the window's max, then the taps in reverse scan order, each
    // equal one overwriting, so that the first in scan order stays.
    for (int line = slot; line < kBwdWindows; line += kBwdPixelsPerRound) {
      const int r = line / kBwdGCols;
      const int j = line - r * kBwdGCols;
      const int wo = w0 - 1 + j;
      uint4 arg = make_uint4(kNoneLanes, kNoneLanes, kNoneLanes, kNoneLanes);
      if (ho0 + r < Ho && wo >= 0 && wo < W) {
        uint4 a[9];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          a[tap] = lds(xs + swz((2 * r + tap / 3) * kBwdXCols + j + tap % 3, k));
        }
        uint4 m = a[0];
#pragma unroll
        for (int tap = 1; tap < 9; ++tap) {
#pragma unroll
          for (int wd = 0; wd < 4; ++wd) words(m)[wd] = lane_max<T>(words(m)[wd], words(a[tap])[wd]);
        }
#pragma unroll
        for (int tap = 8; tap >= 0; --tap) {
          const uint32_t v = lane_int<T>(tap);
#pragma unroll
          for (int wd = 0; wd < 4; ++wd) {
            const uint32_t e = lane_eq<T>(words(a[tap])[wd], words(m)[wd]);
            words(arg)[wd] = (v & e) | (words(arg)[wd] & ~e);
          }
        }
      }
      sts(args + line * kLine + k * 16, arg);
    }
    __syncthreads();

    // 3. Each owned element gathers its routed gradient in tap scan order.
#pragma unroll
    for (int o = 0; o < kBwdOwned; ++o) {
      const int q = slot + o * kBwdPixelsPerRound;
      const int hr = q / kBwdStrip;
      const int wr = q - hr * kBwdStrip;
      const int h = 2 * ho0 + hr;
      const int w = w0 + wr;
      if (!live || h >= H || w >= W) continue;
      uint4 dsum = make_uint4(0u, 0u, 0u, 0u);  // +0 in every lane
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        if ((hr + 1 - kh) & 1) continue;  // x row h is tap kh of window (h + 1 - kh) / 2
        const int r = (hr + 1 - kh) >> 1;
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const int line = r * kBwdGCols + wr + 2 - kw;
          uint4 arg = lds(args + line * kLine + k * 16);
          const uint32_t v = lane_int<T>(kh * 3 + kw);
          uint32_t e[4];
#pragma unroll
          for (int wd = 0; wd < 4; ++wd) e[wd] = lane_eq<T>(words(arg)[wd], v);
          uint4 gv = lds(gs + swz(line, k));
          // an unclaimed lane adds +0: the sum stays (it is never -0)
#pragma unroll
          for (int wd = 0; wd < 4; ++wd) {
            words(dsum)[wd] = lane_add<T>(words(dsum)[wd], words(gv)[wd] & e[wd]);
          }
        }
      }
      float da[kN], xv[kN], out[kN];
      unpack(dsum, da);
      unpack(xr[o], xv);
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const float a_pre = __fadd_rn(__fmul_rn(xv[i], sc[i]), sh[i]);
        const float d = a_pre > 0.f ? da[i] : (a_pre < 0.f ? 0.f : 0.5f * da[i]);
        out[i] = __fmul_rn(d, sc[i]);  // pack rounds it to T
        ds[i] += d * xv[i];
        dt[i] += d;
      }
      store_chunk(dx + ((static_cast<long long>(b) * H + h) * W + w) * C + c, pack(out));
    }
    // The next tile's TMA writes where these threads wrote.
    hopper::fence_proxy_async();
    __syncthreads();
  }

  // The block's sums, added over the thread slots in a fixed order.
  float* red = reinterpret_cast<float*>(xbuf);  // [slot][2][kCc]
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    red[(slot * 2 + 0) * kCc + k * kN + i] = ds[i];
    red[(slot * 2 + 1) * kCc + k * kN + i] = dt[i];
  }
  __syncthreads();
  float* out = partial + static_cast<size_t>(blockIdx.x / n_chunks) * 2 * C;
  for (int j = tid; j < 2 * kCc; j += kBwdThreads) {
    const int which = j / kCc;
    const int ch = j - which * kCc;
    if (c0 + ch >= C) continue;
    float acc = 0.f;
    for (int s = 0; s < kBwdPixelsPerRound; ++s) acc += red[(s * 2 + which) * kCc + ch];
    out[which * C + c0 + ch] = acc;
  }
}

// ---------------------------------------------------------------------------
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int sm_count() {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    sms = 132;
  }
  return sms;
}

// A 4-D map (C, W, rows, B) of a channels-last tensor [B, rows, W, C] with
// boxes of one 128-byte chunk x box_w columns x box_h rows, swizzled.
template <typename T>
bool channels_last_map(CUtensorMap* map, const void* base, int B, int rows, int W, int C,
                       int box_w, int box_h) {
  const uint64_t e = sizeof(T);
  const uint64_t dims[4] = {static_cast<uint64_t>(C), static_cast<uint64_t>(W),
                            static_cast<uint64_t>(rows), static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {C * e, static_cast<uint64_t>(W) * C * e,
                               static_cast<uint64_t>(rows) * W * C * e};
  const uint32_t box[4] = {static_cast<uint32_t>(kLine / e), static_cast<uint32_t>(box_w),
                           static_cast<uint32_t>(box_h), 1};
  return hopper::make_map(map, base, 4, dims, strides, box, Elem<T>::kMap);
}

template <typename T>
cudaError_t launch_fwd(const void* x, const float* scale, const float* shift, void* y, int B,
                       int H, int W, int C, cudaStream_t stream) {
  constexpr int kCc = kLine / static_cast<int>(sizeof(T));
  const int n_chunks = (C + kCc - 1) / kCc;
  const int n_strips = (W + kFwdStrip - 1) / kFwdStrip;
  const int n_bands = (H / 2 + kFwdBand - 1) / kFwdBand;
  const long long tiles = static_cast<long long>(B) * n_bands * n_strips * n_chunks;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  // the runtime call first: it makes the context current for the encoder
  const cudaError_t err = allow_smem(pool_fwd_kernel<T>, kFwdSmem);
  if (err != cudaSuccess) return err;
  CUtensorMap mx;
  if (!channels_last_map<T>(&mx, x, B, H, W, C, kFwdCols, kFwdRows)) {
    return cudaErrorInvalidValue;
  }
  pool_fwd_kernel<T><<<static_cast<unsigned>(tiles), kFwdThreads, kFwdSmem, stream>>>(
      mx, scale, shift, static_cast<T*>(y), H, W, C, n_chunks, n_strips, n_bands);
  return cudaGetLastError();
}

template <typename T, bool kNchw>
cudaError_t launch_bwd(const void* g, const void* x, const float* scale, const float* shift,
                       void* dx, float* dscale, float* dshift, float* partial, int B, int H,
                       int W, int C, int max_blocks, cudaStream_t stream) {
  constexpr int kCc = kLine / static_cast<int>(sizeof(T));
  const int Ho = H / 2;
  const int n_chunks = (C + kCc - 1) / kCc;
  const int n_strips = (W + kBwdStrip - 1) / kBwdStrip;
  const int n_bands = (Ho + kBwdBand - 1) / kBwdBand;
  const long long groups = static_cast<long long>(B) * n_bands * n_strips;
  constexpr int smem = bwd_smem<T, kNchw>();
  static_assert(smem <= 232448, "a block's shared memory");
  auto kernel = pool_bwd_kernel<T, kNchw>;
  // A runtime call first: it makes the device's context current in this
  // thread (an autograd worker may not have one yet), which
  // cuTensorMapEncodeTiled needs.
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap mx, mg;
  bool ok = channels_last_map<T>(&mx, x, B, H, W, C, kBwdXCols, kBwdXRows);
  if (kNchw) {  // [B, C, Ho, W]: dims (W, Ho, C, B), a box of [chunk][rows][columns]
    const uint64_t e = sizeof(T);
    const uint64_t dims[4] = {static_cast<uint64_t>(W), static_cast<uint64_t>(Ho),
                              static_cast<uint64_t>(C), static_cast<uint64_t>(B)};
    const uint64_t strides[3] = {W * e, static_cast<uint64_t>(Ho) * W * e,
                                 static_cast<uint64_t>(C) * Ho * W * e};
    const uint32_t box[4] = {static_cast<uint32_t>(nchw_box_cols<T>()), kBwdGRows,
                             static_cast<uint32_t>(kCc), 1};
    ok = ok && hopper::make_map(&mg, g, 4, dims, strides, box, Elem<T>::kMap,
                                CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {
    ok = ok && channels_last_map<T>(&mg, g, B, Ho, W, C, kBwdGCols, kBwdGRows);
  }
  if (!ok) return cudaErrorInvalidValue;
  long long rows = sm_count() / n_chunks;  // a block a SM
  if (rows < 1) rows = 1;
  if (rows > groups) rows = groups;
  if (rows > max_blocks) rows = max_blocks;
  kernel<<<static_cast<unsigned>(rows * n_chunks), kBwdThreads, smem, stream>>>(
      mx, mg, scale, shift, static_cast<T*>(dx), partial, H, W, C, n_chunks, n_strips, n_bands,
      groups * n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return stem::launch_sum_partials(partial, static_cast<int>(rows), C, dscale, dshift, stream);
}

template <typename T>
cudaError_t launch_bwd_layout(const void* g, const void* x, const float* sc, const float* sh,
                              void* dx, float* ds, float* dt, float* part, int B, int H, int W,
                              int C, int max_blocks, bool g_nchw, cudaStream_t s) {
  return g_nchw ? launch_bwd<T, true>(g, x, sc, sh, dx, ds, dt, part, B, H, W, C, max_blocks, s)
                : launch_bwd<T, false>(g, x, sc, sh, dx, ds, dt, part, B, H, W, C, max_blocks,
                                       s);
}

}  // namespace

// x [B, H, W, C] row-major (bf16 if dtype == 1, float32 if 0), H even,
// C % 8 == 0, every pointer 16-byte aligned; scale/shift [C] float32; y
// [B, H/2, W, C] out. Returns cudaGetLastError().
extern "C" int htrvt_pool_bn_relu_fwd(const void* x, const void* scale,
                                      const void* shift, void* y, int B, int H,
                                      int W, int C, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || (H & 1) || C % 8) {
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

// g [B, H/2, W, C] (g_nchw == 0) or [B, C, H/2, W] with W * itemsize % 16
// == 0 (g_nchw == 1), and x [B, H, W, C] (same dtype, rules as the
// forward); dx [B, H, W, C] out; dscale, dshift [C] float32 out; partial a
// float32 scratch of max_blocks * 2 * C. Returns cudaGetLastError().
extern "C" int htrvt_pool_bn_relu_bwd(const void* g, const void* x,
                                      const void* scale, const void* shift,
                                      void* dx, void* dscale, void* dshift,
                                      void* partial, int B, int H, int W,
                                      int C, int max_blocks, int g_nchw, int dtype,
                                      void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || (H & 1) || C % 8 || max_blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  float* ds = static_cast<float*>(dscale);
  float* dt = static_cast<float*>(dshift);
  float* part = static_cast<float*>(partial);
  const bool nchw = g_nchw != 0;
  const cudaError_t err =
      dtype == stem::kBFloat16
          ? launch_bwd_layout<__nv_bfloat16>(g, x, sc, sh, dx, ds, dt, part, B, H, W, C,
                                             max_blocks, nchw, s)
          : launch_bwd_layout<float>(g, x, sc, sh, dx, ds, dt, part, B, H, W, C, max_blocks,
                                     nchw, s);
  return static_cast<int>(err);
}
