// Flash attention, forward (K5f) and backward (K5dkv, K5dq), for Hopper,
// sm_90a.
//
// Replaces the library Pallas TPU kernel that htr_vt_tpu/models/vit.py:67
// flash_mha calls (jax/experimental/pallas/ops/tpu/flash_attention.py):
// _flash_attention_kernel_single_batch (:342-481, and the single-step
// variant :484-557 when N = 128), _flash_attention_dkv_kernel (:796-938)
// and _flash_attention_dq_kernel (:1146-1284), at the library's default
// 128-row blocks. The plain PyTorch versions with the same inputs and
// outputs are htr_vt_torch/ops/flash_attn.py: flash_attention_reference,
// flash_attention_dkv_reference and flash_attention_dq_reference.
//
// Shapes: q, k, v, o, do [B, H, N, D] with D a multiple of 128 and N a
// multiple of 128, read through element strides (b, h, n) with the last dim
// contiguous, so the strided views of a fused qkv projection need no copy;
// dq, dk, dv contiguous [B, H, N, D]; l, m, di float32 [B, H, N]. T = the
// element type (bf16, or float32), every sum float32:
//
//   K5f, per 128-key block j:   s = (q k_j^T) * scale
//       m' = max(m, rowmax s), p = exp(s - m'), l_corr = exp(m - m') * l,
//       l' = rowsum p + l_corr, acc = acc * (l_corr / l') + (T(p) v_j) / l'
//     o = T(acc); with one key block p = exp(s - m) / l, o = T(T(p) v).
//   K5dkv / K5dq, per pair of blocks:   p = exp(s - m) * (1 / l),
//       dp = do v^T, ds = (dp - di) * p * scale,
//       dv += T(p)^T do, dk += T(ds)^T q, dq += T(ds) k,   cast once at the end.
//
// The scale multiply, the l update and the accumulator rescale round as
// the library does (__fmul_rn / __fadd_rn: no FMA contraction). The key
// step is the library's 128 keys in every kernel: the running max, sum and
// rescale happen once per 128 keys, so a different step would give other
// bits.
//
// What bounds them on this card. At the 2048-px serving shape [128, 6, 512,
// 128] K5f does 4 * B*H*N^2*D = 103.1 GFLOP (0.104 ms at the H100's 989
// TFLOP/s bf16 dense) and moves 402.7 MB (0.120 ms at 3.35 TB/s): bytes by
// a little, so the kernel has to read each byte once and keep the tensor
// cores busy while it does. At the 2048-px training shape [64, 6, 512, 128]
// K5dkv (8 * B*H*N^2*D = 103.1 GFLOP, 0.104 ms) and K5dq (6 * B*H*N^2*D =
// 77.3 GFLOP, 0.078 ms) are bound by operations. The plain version writes
// the float32 score matrix, [B, H, N, N]: 805 MB a layer at the serving
// shape.
//
// K5f, bf16: a warp-specialised wgmma kernel fed by TMA. A block owns 128
// queries of one (b, h) and has three warpgroups:
// - the producer (one thread of warpgroup 2, 40 registers after
//   setmaxnreg) loads the q tile once and then k_j and v_j for every key
//   block by TMA into a ring of 32 KB units (128 keys x 128 of D; six units
//   at D = 128, five at D = 256), each unit with a full and an empty
//   mbarrier, so block j + 1 (and more) loads while block j computes. The
//   tensor maps are 4-D (D, N, H, B) over the element strides, so the qkv
//   views load without a copy; boxes are 64 columns wide with the 128-byte
//   swizzle, wgmma's canonical layout.
// - two consumer warpgroups (232 registers) own 64 query rows each:
//   s = q k^T is wgmma m64n128k16 from shared memory (q and k K-major); the
//   softmax runs on the accumulator fragments; T(p) is packed in registers
//   into the A operand of p v, which is wgmma m64n64k16 with A from
//   registers and v as an MN-major (transposed) B from shared memory, one
//   64-column slice of D at a time (two in flight at D = 128). Each slice
//   has an accumulator of its own that starts at zero (scale-d = 0) and is
//   then folded into acc as acc + (p v) * (1 / l'): (p v) / l' is a
//   product of its own, never accumulated into acc.
// o is written from the registers as [B, N, H, D] seen as [B, H, N, D], so
// the heads merge without a copy; l and m are float32 [B, H, N].
//
// K5dkv, bf16: the same shape of kernel (flash_dkv_wgmma below). A block
// owns 128 keys of one (b, h) and walks the queries 64 at a time, so dk and
// dv need no atomics and dq stays a kernel of its own, as in the library:
// two calls give equal bits. The producer loads k and v once, then q, do
// (the same 4-D strided maps as K5f) and the softmax statistics of each
// query step into rings; two consumer warpgroups own 64 keys each and
// compute the transposed tiles s^T = k q^T and dp^T = v do^T (wgmma from
// shared memory), so that p^T and ds^T, packed to bf16 in registers, are
// the A operands of dv += p^T do and dk += ds^T q (do and q as MN-major B).
// K5dq, bf16: K5dkv with the roles of queries and keys swapped
// (flash_dq_wgmma below). A block owns 128 queries of one (b, h): the
// producer loads q and do once and k and v for each 64-key step into a
// ring; two consumer warpgroups own 64 queries each, compute s = q k^T and
// dp = do v^T (wgmma from shared memory), form p and ds on the accumulator
// fragments with each query row's statistics held in registers, and
// multiply T(ds), packed in registers, by k as an MN-major B into dq.
// Nothing of size [N, N] leaves the chip. At D = 256 a block of either
// makes one 128-column slice of its output (gridDim.z = D / 128),
// recomputing the scores over the whole of D.
// float32 (every kernel) runs a 128 x 128 FFMA tile (8 x 8 outputs a
// thread) with the probabilities in shared memory (no TF32), one
// 128-column slice of the output a block, the scores recomputed for each.
// The wgmma kernels hold a [128, D] tile and a D-wide accumulator, which
// stop fitting past D = 256 (at D = 512, 128 KB of q beside the ring, and
// 256 accumulator registers a thread). So bf16 at D = 384, 512 and every
// larger multiple of 128 runs the same FFMA kernels, widening bf16 as it
// stages and rounding p, ds and the outputs to bf16 where the wgmma kernels
// do: a simple kernel whose shared memory does not grow with D.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

constexpr int kBlock = 128;      // queries or keys a block owns; the library's blocks
constexpr int kThreads = 256;    // 8 warps (float32)
constexpr int kWarpRows = 16;    // a warp's rows: one m16 tile
constexpr int kDO = 128;         // output columns a backward / float32 block makes
constexpr int kSub = 64;         // K5dkv's queries, K5dq's keys, per step
constexpr int kFP = 129;         // float32 row pitch in shared memory
constexpr int kFK = 32;          // float32 staging chunk

constexpr size_t kF32Smem = sizeof(float) * (kBlock * kFP + 2 * kFK * kFP + 3 * kBlock);

// Element strides of a [B, H, N, D] tensor; the last dim is contiguous.
struct Strides {
  long long b, h, n;
};
// q, k, v, then o (K5f) or do (K5dkv, K5dq).
struct Layout {
  Strides t[4];
};

template <typename T>
__device__ __forceinline__ const T* rows_of(const T* base, const Strides& s, int b, int h,
                                            long long row) {
  return base + b * s.b + h * s.h + row * s.n;
}

// --- small helpers ---------------------------------------------------------
// Two floats rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Row max / sum over the 4 lanes of a quad, which hold one row's columns.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// --- K5f, bf16: wgmma fed by TMA --------------------------------------------------
constexpr int kFwdThreads = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kConsumerWarps = 8;
constexpr int kBox = kBlock * hopper::kSwizzleBytes;  // 16 KB: 128 rows x 64 columns
constexpr int kUnit = 2 * kBox;                       // 32 KB: 128 rows x 128 columns

template <int D>
struct Fwd {
  static constexpr int kBoxes = D / 64;                 // boxes of a [128, D] tile
  static constexpr int kUnits = D / 128;                // units of a k (or v) block
  static constexpr int kRing = D == 128 ? 6 : 5;        // units in flight
  static constexpr int kPvInFlight = D == 128 ? 2 : 1;  // 64-column p v slices at once
  static constexpr size_t kSmem = hopper::kSwizzleAlign + static_cast<size_t>(kBoxes) * kBox +
                                  static_cast<size_t>(kRing) * kUnit +
                                  sizeof(uint64_t) * (1 + 2 * kRing);
};

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                float* __restrict__ l_out, float* __restrict__ m_out, Strides so, int H,
                int N, float scale) {
  using C = Fwd<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = hopper::align_swizzle(smem_raw);
  unsigned char* ring = qs + C::kBoxes * kBox;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + C::kRing * kUnit);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + C::kRing;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * kBlock;
  const int nk = N / kBlock;
  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int i = 0; i < C::kRing; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], kConsumerWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: q once, then per key block k's units and v's units, in the
    // order the consumers take them.
    hopper::setmaxnreg_dec<40>();
    if (tid == 2 * 128) {
      hopper::mbar_expect_tx(q_full, C::kBoxes * kBox);
      for (int x = 0; x < C::kBoxes; ++x) {
        hopper::tma_load_4d(qs + x * kBox, &tq, q_full, x * 64, q0, h, b);
      }
      hopper::Ring r(C::kRing);
      for (int j = 0; j < nk; ++j) {
        for (int kv = 0; kv < 2; ++kv) {
          const CUtensorMap* map = kv ? &tv : &tk;
          for (int u = 0; u < C::kUnits; ++u) {
            hopper::mbar_wait(&empty[r.slot], r.phase ^ 1u);
            hopper::mbar_expect_tx(&full[r.slot], kUnit);
            for (int x = 0; x < 2; ++x) {
              hopper::tma_load_4d(ring + r.slot * kUnit + x * kBox, map, &full[r.slot],
                                  (2 * u + x) * 64, j * kBlock, h, b);
            }
            r.next();
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile; its
    // warp w rows 16 w .. 16 w + 15 of those (accumulator rows g, g + 8).
    hopper::setmaxnreg_inc<232>();
    const int lane = tid & 31, warp = (tid >> 5) & 3;
    const int row0 = wg * 64 + warp * kWarpRows;
    const uint32_t q_addr = hopper::smem_u32(qs) + wg * 64 * hopper::kSwizzleBytes;
    const uint32_t ring_addr = hopper::smem_u32(ring);
    float acc[D / 2];  // [D / 8 column octets][4], the m64nD accumulator layout
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
    hopper::Ring r(C::kRing);
    hopper::mbar_wait(q_full, 0);
    for (int j = 0; j < nk; ++j) {
      int slots[C::kUnits];
#pragma unroll
      for (int u = 0; u < C::kUnits; ++u) {
        slots[u] = r.slot;
        hopper::mbar_wait(&full[r.slot], r.phase);
        r.next();
      }
      // s = q k_j^T over D, 16 columns of D a product
      float s[64];
      hopper::wgmma_fence();
#pragma unroll
      for (int u = 0; u < C::kUnits; ++u)
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint32_t off = x * kBox + kk * 32;
            hopper::wgmma_m64n128k16_ss(
                s, hopper::sw128_desc(q_addr + (2 * u) * kBox + off),
                hopper::sw128_desc(ring_addr + slots[u] * kUnit + off), (u | x | kk) != 0);
          }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < C::kUnits; ++u) hopper::mbar_arrive(&empty[slots[u]]);
      }

      // the streaming softmax; s[4 nt + e] is row g (e < 2) or g + 8 (e >= 2)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        s[i] = __fmul_rn(s[i], scale);
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
      float corr[2], inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = quad_max(mx[i]);
        if (nk > 1) mx[i] = fmaxf(m_run[i], mx[i]);  // m'
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        s[i] = expf(__fsub_rn(s[i], mx[(i >> 1) & 1]));
        sum[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] = quad_sum(sum[i]);
        if (nk == 1) {  // the single-step kernel: p / l, then the cast
          corr[i] = 0.f;
          inv[i] = 1.f;
          l_run[i] = sum[i];
        } else {
          const float l_corr = __fmul_rn(expf(__fsub_rn(m_run[i], mx[i])), l_run[i]);
          const float l_next = __fadd_rn(sum[i], l_corr);
          inv[i] = l_next == 0.f ? 1.f : 1.f / l_next;
          corr[i] = __fmul_rn(l_corr, inv[i]);
          l_run[i] = l_next;
        }
        m_run[i] = mx[i];
      }
      if (nk == 1) {
#pragma unroll
        for (int i = 0; i < 64; ++i) s[i] = s[i] / sum[(i >> 1) & 1];
      }
      // T(p) as the A fragments of p v: 16 keys a fragment
      uint32_t pa[kBlock / 16][4];
#pragma unroll
      for (int ks = 0; ks < kBlock / 16; ++ks) {
        pa[ks][0] = pack_bf16(s[8 * ks + 0], s[8 * ks + 1]);
        pa[ks][1] = pack_bf16(s[8 * ks + 2], s[8 * ks + 3]);
        pa[ks][2] = pack_bf16(s[8 * ks + 4], s[8 * ks + 5]);
        pa[ks][3] = pack_bf16(s[8 * ks + 6], s[8 * ks + 7]);
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = __fmul_rn(acc[i], corr[(i >> 1) & 1]);

      // acc += (p v_j) * (1 / l'), 64 columns of D a slice
#pragma unroll
      for (int u = 0; u < C::kUnits; ++u) {
        slots[u] = r.slot;
        hopper::mbar_wait(&full[r.slot], r.phase);
        r.next();
      }
#pragma unroll
      for (int c0 = 0; c0 < D / 64; c0 += C::kPvInFlight) {
        float pv[C::kPvInFlight][32];
        hopper::wgmma_fence();
#pragma unroll
        for (int f = 0; f < C::kPvInFlight; ++f) {
          const int c = c0 + f;
          const uint32_t base = ring_addr + slots[c >> 1] * kUnit + (c & 1) * kBox;
#pragma unroll
          for (int ks = 0; ks < kBlock / 16; ++ks) {
            hopper::wgmma_m64n64k16_rs_tb(
                pv[f], pa[ks], hopper::sw128_desc(base + ks * 16 * hopper::kSwizzleBytes),
                ks != 0);
          }
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int f = 0; f < C::kPvInFlight; ++f) {
          hopper::fence_regs(pv[f]);
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            float& a = acc[(c0 + f) * 32 + i];
            a = __fadd_rn(a, __fmul_rn(pv[f][i], inv[(i >> 1) & 1]));
          }
        }
      }
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < C::kUnits; ++u) hopper::mbar_arrive(&empty[slots[u]]);
      }
    }
    const int g = lane >> 2, t4 = lane & 3;
    bf16* out = o + b * so.b + h * so.h + static_cast<long long>(q0 + row0) * so.n;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const int c = nt * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(out + g * so.n + c) =
          pack_bf16(acc[4 * nt], acc[4 * nt + 1]);
      *reinterpret_cast<uint32_t*>(out + (g + 8) * so.n + c) =
          pack_bf16(acc[4 * nt + 2], acc[4 * nt + 3]);
    }
    if (t4 == 0) {
      const long long row = static_cast<long long>(blockIdx.y) * N + q0 + row0 + g;
      l_out[row] = l_run[0];
      l_out[row + 8] = l_run[1];
      m_out[row] = m_run[0];
      m_out[row + 8] = m_run[1];
    }
  }
}

// --- K5dkv, bf16: wgmma fed by TMA -------------------------------------------------
// A block owns 128 keys of one (b, h) and one 128-column slice of dk and dv
// (gridDim.z = D / 128) and walks the queries 64 at a time. Warpgroup 2's
// first thread loads k and v once, then for each query step the softmax
// statistics (m, l, di of the 64 queries: three bulk copies into a ring of
// four) and q and do as 16 KB units (64 queries x 128 of D, two boxes)
// into a ring, so the next steps load while this one computes. Consumer
// warpgroups 0 and 1 own 64 keys each:
// s^T = k q^T and dp^T = v do^T are wgmma m64n64k16 from shared memory
// (both operands K-major); p^T and ds^T are computed on the accumulator
// fragments and packed to bf16 in registers as the A operands of dv +=
// p^T do and dk += ds^T q, wgmma m64n64k16 with do and q as MN-major B
// (two 64-column halves of the slice). Within a warpgroup p^T is computed
// while dp^T's products run. 232 registers a consumer thread (dk and dv
// 128, s^T and dp^T 64; 40 for warpgroup 2).
constexpr int kQBox = kSub * hopper::kSwizzleBytes;  // 8 KB: 64 rows x 64 columns
constexpr int kQUnit = 2 * kQBox;                    // 16 KB: 64 rows x 128 columns
constexpr int kStatRing = 4;

template <int D>
struct Dkv {
  static constexpr int kKvBoxes = D / 64;          // boxes of a [128, D] k (or v) tile
  static constexpr int kUnits = D / 128;           // units of a q (or do) step
  static constexpr int kRing = D == 128 ? 6 : 5;   // units in flight
  static constexpr size_t kSmem = hopper::kSwizzleAlign +
                                  2 * static_cast<size_t>(kKvBoxes) * kBox +
                                  static_cast<size_t>(kRing) * kQUnit +
                                  sizeof(float) * kStatRing * 3 * kSub +
                                  sizeof(uint64_t) * (1 + 2 * kRing + 2 * kStatRing);
};

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_dkv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ l, const float* __restrict__ m,
                const float* __restrict__ di, bf16* __restrict__ dk, bf16* __restrict__ dv,
                int H, int N, float scale) {
  using C = Dkv<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* kvs = hopper::align_swizzle(smem_raw);  // k's boxes, then v's
  unsigned char* ring = kvs + 2 * C::kKvBoxes * kBox;
  float* stats = reinterpret_cast<float*>(ring + C::kRing * kQUnit);  // [slot][m, l, di][64]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + kStatRing * 3 * kSub);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + C::kRing;
  uint64_t* st_full = empty + C::kRing;
  uint64_t* st_empty = st_full + kStatRing;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int k0 = blockIdx.x * kBlock;
  const int steps = N / kSub;
  if (tid == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int i = 0; i < C::kRing; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], kConsumerWarps);
    }
    for (int i = 0; i < kStatRing; ++i) {
      hopper::mbar_init(&st_full[i], 1);
      hopper::mbar_init(&st_empty[i], kConsumerWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    hopper::setmaxnreg_dec<40>();
    if (tid == 2 * 128) {
      hopper::mbar_expect_tx(kv_full, 2 * C::kKvBoxes * kBox);
      for (int x = 0; x < C::kKvBoxes; ++x) {
        hopper::tma_load_4d(kvs + x * kBox, &tk, kv_full, x * 64, k0, h, b);
        hopper::tma_load_4d(kvs + (C::kKvBoxes + x) * kBox, &tv, kv_full, x * 64, k0, h, b);
      }
      hopper::Ring r(C::kRing), sr(kStatRing);
      for (int i = 0; i < steps; ++i) {
        const long long row = static_cast<long long>(blockIdx.y) * N + i * kSub;
        hopper::mbar_wait(&st_empty[sr.slot], sr.phase ^ 1u);
        hopper::mbar_expect_tx(&st_full[sr.slot], 3 * kSub * sizeof(float));
        float* st = stats + sr.slot * 3 * kSub;
        hopper::bulk_load(st, m + row, kSub * sizeof(float), &st_full[sr.slot]);
        hopper::bulk_load(st + kSub, l + row, kSub * sizeof(float), &st_full[sr.slot]);
        hopper::bulk_load(st + 2 * kSub, di + row, kSub * sizeof(float), &st_full[sr.slot]);
        sr.next();
        for (int t = 0; t < 2; ++t) {  // q, then do
          const CUtensorMap* map = t ? &tdo : &tq;
          for (int u = 0; u < C::kUnits; ++u) {
            hopper::mbar_wait(&empty[r.slot], r.phase ^ 1u);
            hopper::mbar_expect_tx(&full[r.slot], kQUnit);
            for (int x = 0; x < 2; ++x) {
              hopper::tma_load_4d(ring + r.slot * kQUnit + x * kQBox, map, &full[r.slot],
                                  (2 * u + x) * 64, i * kSub, h, b);
            }
            r.next();
          }
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<232>();
    const int lane = tid & 31, warp = (tid >> 5) & 3;
    const int t4 = lane & 3;
    const uint32_t k_addr = hopper::smem_u32(kvs) + wg * 64 * hopper::kSwizzleBytes;
    const uint32_t v_addr = k_addr + C::kKvBoxes * kBox;
    const uint32_t ring_addr = hopper::smem_u32(ring);
    // dk and dv: [two 64-column halves of the slice][the m64n64 layout]
    float dk_acc[2][32], dv_acc[2][32];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
#pragma unroll
      for (int i = 0; i < 32; ++i) dk_acc[x][i] = dv_acc[x][i] = 0.f;
      hopper::fence_regs(dk_acc[x]);
      hopper::fence_regs(dv_acc[x]);
    }
    hopper::Ring r(C::kRing), sr(kStatRing);
    hopper::mbar_wait(kv_full, 0);
    for (int i = 0; i < steps; ++i) {
      hopper::mbar_wait(&st_full[sr.slot], sr.phase);
      int qs[C::kUnits], os[C::kUnits];
#pragma unroll
      for (int u = 0; u < C::kUnits; ++u) {
        qs[u] = r.slot;
        hopper::mbar_wait(&full[r.slot], r.phase);
        r.next();
      }
#pragma unroll
      for (int u = 0; u < C::kUnits; ++u) {
        os[u] = r.slot;
        hopper::mbar_wait(&full[r.slot], r.phase);
        r.next();
      }
      // s^T = k q^T, then dp^T = v do^T, over D: 16 columns of D a
      // product, each a commit group of its own
      float s[32], dp[32];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t koff = (kk >> 2) * kBox + (kk & 3) * 32;
        const uint32_t qoff = ((kk >> 2) & 1) * kQBox + (kk & 3) * 32;
        hopper::wgmma_m64n64k16_ss(s, hopper::sw128_desc(k_addr + koff),
                                   hopper::sw128_desc(ring_addr + qs[kk >> 3] * kQUnit + qoff),
                                   kk != 0);
      }
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t koff = (kk >> 2) * kBox + (kk & 3) * 32;
        const uint32_t qoff = ((kk >> 2) & 1) * kQBox + (kk & 3) * 32;
        hopper::wgmma_m64n64k16_ss(dp, hopper::sw128_desc(v_addr + koff),
                                   hopper::sw128_desc(ring_addr + os[kk >> 3] * kQUnit + qoff),
                                   kk != 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // s^T is in
      hopper::fence_regs(s);

      // p^T = exp(s^T * scale - m) * (1 / l); s[4 nt + e] is key row g
      // (e < 2) or g + 8 and query column 8 nt + 2 t + e % 2, whose
      // statistics are the column's
      const float* st = stats + sr.slot * 3 * kSub;
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = nt * 8 + 2 * t4 + e;
          const float mc = st[c], il = 1.f / st[kSub + c];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float& v = s[4 * nt + 2 * half + e];
            v = __fmul_rn(expf(__fsub_rn(__fmul_rn(v, scale), mc)), il);
          }
        }
      hopper::wgmma_wait<0>();  // dp^T is in
      hopper::fence_regs(dp);
      // ds^T = (dp^T - di) p^T scale
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dc = st[2 * kSub + nt * 8 + 2 * t4 + e];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int idx = 4 * nt + 2 * half + e;
            dp[idx] = __fmul_rn(__fmul_rn(__fsub_rn(dp[idx], dc), s[idx]), scale);
          }
        }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&st_empty[sr.slot]);
      sr.next();
      // T(p^T) and T(ds^T) as A fragments, 16 queries a fragment; dv +=
      // T(p^T) do and dk += T(ds^T) q over the slice's 128 columns
      uint32_t pa[kSub / 16][4], da[kSub / 16][4];
#pragma unroll
      for (int ks = 0; ks < kSub / 16; ++ks)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pa[ks][j] = pack_bf16(s[8 * ks + 2 * j], s[8 * ks + 2 * j + 1]);
          da[ks][j] = pack_bf16(dp[8 * ks + 2 * j], dp[8 * ks + 2 * j + 1]);
        }
      const bool hi = C::kUnits > 1 && blockIdx.z > 0;  // the slice's unit (no dynamic index)
      const uint32_t o_unit = ring_addr + (hi ? os[C::kUnits - 1] : os[0]) * kQUnit;
      const uint32_t q_unit = ring_addr + (hi ? qs[C::kUnits - 1] : qs[0]) * kQUnit;
      hopper::wgmma_fence();
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int ks = 0; ks < kSub / 16; ++ks) {
          const uint32_t off = x * kQBox + ks * 16 * hopper::kSwizzleBytes;
          hopper::wgmma_m64n64k16_rs_tb(dv_acc[x], pa[ks], hopper::sw128_desc(o_unit + off), 1);
          hopper::wgmma_m64n64k16_rs_tb(dk_acc[x], da[ks], hopper::sw128_desc(q_unit + off), 1);
        }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < C::kUnits; ++u) {
          hopper::mbar_arrive(&empty[qs[u]]);
          hopper::mbar_arrive(&empty[os[u]]);
        }
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      hopper::fence_regs(dk_acc[x]);
      hopper::fence_regs(dv_acc[x]);
    }
    const int g = lane >> 2;
    const long long out = (static_cast<long long>(blockIdx.y) * N + k0 + wg * 64 +
                           warp * kWarpRows + g) * D + blockIdx.z * kDO;
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = x * 64 + nt * 8 + 2 * t4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long at = out + half * 8 * D + c;
          const int e = 4 * nt + 2 * half;
          *reinterpret_cast<uint32_t*>(dk + at) = pack_bf16(dk_acc[x][e], dk_acc[x][e + 1]);
          *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16(dv_acc[x][e], dv_acc[x][e + 1]);
        }
      }
  }
}

// --- K5dq, bf16: wgmma fed by TMA --------------------------------------------------
// A block owns 128 queries of one (b, h) and one 128-column slice of dq
// (gridDim.z = D / 128) and walks the keys 64 at a time. Warpgroup 2's first
// thread loads q and do once (K5f's 4-D strided maps, 128-row boxes), then for
// each key step k and v as 16 KB units (64 keys x 128 of D, two boxes) into a
// ring, so the next steps load while this one computes. Consumer warpgroups 0
// and 1 own 64 queries each and hold each query row's m, 1 / l and di in
// registers: s = q k^T and dp = do v^T are wgmma m64n64k16 from shared memory
// (all operands K-major), p is computed while dp's products run, and ds, packed
// to bf16 in registers, is the A operand of dq += T(ds) k, wgmma m64n64k16 with
// k as an MN-major B (two 64-column halves of the slice). v's units are
// released once dp is in, k's once dq's products are done. 232 registers a
// consumer thread (dq 64, s and dp 64; 40 for warpgroup 2).
template <int D>
struct Dq {
  static constexpr int kQBoxes = D / 64;          // boxes of a [128, D] q (or do) tile
  static constexpr int kUnits = D / 128;          // units of a k (or v) step
  static constexpr int kRing = D == 128 ? 8 : 6;  // units in flight
  static constexpr size_t kSmem = hopper::kSwizzleAlign +
                                  2 * static_cast<size_t>(kQBoxes) * kBox +
                                  static_cast<size_t>(kRing) * kQUnit +
                                  sizeof(uint64_t) * (1 + 2 * kRing);
};

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ l, const float* __restrict__ m,
               const float* __restrict__ di, bf16* __restrict__ dq, int H, int N,
               float scale) {
  using C = Dq<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qos = hopper::align_swizzle(smem_raw);  // q's boxes, then do's
  unsigned char* ring = qos + 2 * C::kQBoxes * kBox;
  uint64_t* qo_full = reinterpret_cast<uint64_t*>(ring + C::kRing * kQUnit);
  uint64_t* full = qo_full + 1;
  uint64_t* empty = full + C::kRing;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * kBlock;
  const int steps = N / kSub;
  if (tid == 0) {
    hopper::mbar_init(qo_full, 1);
    for (int i = 0; i < C::kRing; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], kConsumerWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    hopper::setmaxnreg_dec<40>();
    if (tid == 2 * 128) {
      hopper::mbar_expect_tx(qo_full, 2 * C::kQBoxes * kBox);
      for (int x = 0; x < C::kQBoxes; ++x) {
        hopper::tma_load_4d(qos + x * kBox, &tq, qo_full, x * 64, q0, h, b);
        hopper::tma_load_4d(qos + (C::kQBoxes + x) * kBox, &tdo, qo_full, x * 64, q0, h, b);
      }
      hopper::Ring r(C::kRing);
      for (int i = 0; i < steps; ++i) {
        for (int t = 0; t < 2; ++t) {  // k, then v
          const CUtensorMap* map = t ? &tv : &tk;
          for (int u = 0; u < C::kUnits; ++u) {
            hopper::mbar_wait(&empty[r.slot], r.phase ^ 1u);
            hopper::mbar_expect_tx(&full[r.slot], kQUnit);
            for (int x = 0; x < 2; ++x) {
              hopper::tma_load_4d(ring + r.slot * kQUnit + x * kQBox, map, &full[r.slot],
                                  (2 * u + x) * 64, i * kSub, h, b);
            }
            r.next();
          }
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<232>();
    const int lane = tid & 31, warp = (tid >> 5) & 3;
    const int g = lane >> 2, t4 = lane & 3;
    const uint32_t q_addr = hopper::smem_u32(qos) + wg * 64 * hopper::kSwizzleBytes;
    const uint32_t o_addr = q_addr + C::kQBoxes * kBox;
    const uint32_t ring_addr = hopper::smem_u32(ring);
    // this thread's two query rows (accumulator rows g and g + 8): m, 1 / l
    // and di
    const long long first = static_cast<long long>(blockIdx.y) * N + q0 + wg * 64 +
                            warp * kWarpRows + g;
    const long long out = first * D + blockIdx.z * kDO;
    const float mr[2] = {m[first], m[first + 8]};
    const float il[2] = {1.f / l[first], 1.f / l[first + 8]};
    const float dr[2] = {di[first], di[first + 8]};
    // dq: [two 64-column halves of the slice][the m64n64 layout]
    float dq_acc[2][32];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
#pragma unroll
      for (int i = 0; i < 32; ++i) dq_acc[x][i] = 0.f;
      hopper::fence_regs(dq_acc[x]);
    }
    hopper::Ring r(C::kRing);
    hopper::mbar_wait(qo_full, 0);
    for (int i = 0; i < steps; ++i) {
      int ks[C::kUnits], vs[C::kUnits];
#pragma unroll
      for (int u = 0; u < C::kUnits; ++u) {
        ks[u] = r.slot;
        hopper::mbar_wait(&full[r.slot], r.phase);
        r.next();
      }
#pragma unroll
      for (int u = 0; u < C::kUnits; ++u) {
        vs[u] = r.slot;
        hopper::mbar_wait(&full[r.slot], r.phase);
        r.next();
      }
      // s = q k^T, then dp = do v^T, over D: 16 columns of D a product,
      // each a commit group of its own
      float s[32], dp[32];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t qoff = (kk >> 2) * kBox + (kk & 3) * 32;
        const uint32_t koff = ((kk >> 2) & 1) * kQBox + (kk & 3) * 32;
        hopper::wgmma_m64n64k16_ss(s, hopper::sw128_desc(q_addr + qoff),
                                   hopper::sw128_desc(ring_addr + ks[kk >> 3] * kQUnit + koff),
                                   kk != 0);
      }
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t qoff = (kk >> 2) * kBox + (kk & 3) * 32;
        const uint32_t koff = ((kk >> 2) & 1) * kQBox + (kk & 3) * 32;
        hopper::wgmma_m64n64k16_ss(dp, hopper::sw128_desc(o_addr + qoff),
                                   hopper::sw128_desc(ring_addr + vs[kk >> 3] * kQUnit + koff),
                                   kk != 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // s is in
      hopper::fence_regs(s);
      // p = exp(s * scale - m) * (1 / l); s[4 nt + e] is query row g (e <
      // 2) or g + 8 and key column 8 nt + 2 t + e % 2
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int hh = (j >> 1) & 1;
        s[j] = __fmul_rn(expf(__fsub_rn(__fmul_rn(s[j], scale), mr[hh])), il[hh]);
      }
      hopper::wgmma_wait<0>();  // dp is in
      hopper::fence_regs(dp);
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < C::kUnits; ++u) hopper::mbar_arrive(&empty[vs[u]]);
      }
      // ds = (dp - di) p scale, as T(ds) the A fragments of ds k, 16 keys a
      // fragment
      uint32_t da[kSub / 16][4];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int hh = (j >> 1) & 1;
        dp[j] = __fmul_rn(__fmul_rn(__fsub_rn(dp[j], dr[hh]), s[j]), scale);
      }
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          da[kk][j] = pack_bf16(dp[8 * kk + 2 * j], dp[8 * kk + 2 * j + 1]);
        }
      const bool hi = C::kUnits > 1 && blockIdx.z > 0;  // the slice's unit (no dynamic index)
      const uint32_t k_unit = ring_addr + (hi ? ks[C::kUnits - 1] : ks[0]) * kQUnit;
      hopper::wgmma_fence();
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int kk = 0; kk < kSub / 16; ++kk) {
          const uint32_t off = x * kQBox + kk * 16 * hopper::kSwizzleBytes;
          hopper::wgmma_m64n64k16_rs_tb(dq_acc[x], da[kk], hopper::sw128_desc(k_unit + off), 1);
        }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < C::kUnits; ++u) hopper::mbar_arrive(&empty[ks[u]]);
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) hopper::fence_regs(dq_acc[x]);
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = x * 64 + nt * 8 + 2 * t4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int e = 4 * nt + 2 * half;
          *reinterpret_cast<uint32_t*>(dq + out + half * 8 * D + c) =
              pack_bf16(dq_acc[x][e], dq_acc[x][e + 1]);
        }
      }
  }
}

// --- float32, and any head_dim, on FFMA ------------------------------------------
// A thread owns the 8 x 8 outputs (ty + 16 i, tx + 16 j) of a 128 x 128
// tile, ty = tid / 16, tx = tid % 16: the 16 threads of a row group are one
// half-warp, so row reductions are shuffles. T is the element type: float,
// or bf16 at a head_dim the wgmma kernels do not take (D > 256), where the
// inputs are widened to float32 as they are staged (a product of two bf16
// values is exact in float32), p and ds are rounded to bf16 as the products
// read them (T(p), T(ds)) and the outputs once at the end, as the wgmma
// kernels round. D = 0 reads the head_dim from the argument d, so one
// instantiation takes every multiple of 128: shared memory does not grow
// with D, and each block makes one 128-column slice of the output.

// Four consecutive elements as float32 (16 bytes of float, 8 of bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// float32 -> T -> float32 (round to nearest even).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// acc[i][j] += sum_d A[ty + 16 i, d] * Bt[tx + 16 j, d] for two [128, D]
// row sets (rows sa, sb elements apart), staged 32 of D at a time,
// transposed, in Ac and Bc (D = 0: d columns).
template <typename T, int D>
__device__ __forceinline__ void nt_product_f32(float acc[8][8], const T* A, long long sa,
                                               const T* Bt, long long sb, float* Ac,
                                               float* Bc, int tid, int d) {
  const int tx = tid & 15, ty = tid >> 4;
  const int dd = D ? D : d;
  for (int d0 = 0; d0 < dd; d0 += kFK) {
#pragma unroll
    for (int i = 0; i < kBlock * kFK / 4 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (kFK / 4), c = (idx % (kFK / 4)) * 4;
      const float4 a = load4(A + r * sa + d0 + c);
      const float4 bb = load4(Bt + r * sb + d0 + c);
      Ac[(c + 0) * kFP + r] = a.x;
      Ac[(c + 1) * kFP + r] = a.y;
      Ac[(c + 2) * kFP + r] = a.z;
      Ac[(c + 3) * kFP + r] = a.w;
      Bc[(c + 0) * kFP + r] = bb.x;
      Bc[(c + 1) * kFP + r] = bb.y;
      Bc[(c + 2) * kFP + r] = bb.z;
      Bc[(c + 3) * kFP + r] = bb.w;
    }
    __syncthreads();
#pragma unroll 4
    for (int d = 0; d < kFK; ++d) {
      float a[8], bb[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = Ac[d * kFP + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bb[j] = Bc[d * kFP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// acc[i][j] += sum_r T(P[ty + 16 i, r]) * B[r, tx + 16 j] over the 128 rows
// r of B ([128, kDO] from B, rows sb elements apart), P in shared memory
// [128][kFP]; B staged 32 rows at a time in Bc.
template <typename T>
__device__ __forceinline__ void p_product_f32(float acc[8][8], const float* Ps, const T* B,
                                              long long sb, float* Bc, int tid) {
  const int tx = tid & 15, ty = tid >> 4;
  for (int r0 = 0; r0 < kBlock; r0 += kFK) {
#pragma unroll
    for (int i = 0; i < kFK * kDO / 4 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (kDO / 4), c = (idx % (kDO / 4)) * 4;
      const float4 bb = load4(B + (r0 + r) * sb + c);
      Bc[r * kFP + c + 0] = bb.x;
      Bc[r * kFP + c + 1] = bb.y;
      Bc[r * kFP + c + 2] = bb.z;
      Bc[r * kFP + c + 3] = bb.w;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kFK; ++r) {
      float a[8], bb[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = round_to<T>(Ps[(ty + 16 * i) * kFP + r0 + r]);
#pragma unroll
      for (int j = 0; j < 8; ++j) bb[j] = Bc[r * kFP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int w = 1; w < 16; w <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, w));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int w = 1; w < 16; w <<= 1) v += __shfl_xor_sync(0xffffffffu, v, w);
  return v;
}

__device__ __forceinline__ void zero88(float acc[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

template <typename T>
__device__ __forceinline__ void store_f32(T* out, long long stride, float acc[8][8], int tid) {
  const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) store1(out + (ty + 16 * i) * stride + tx + 16 * j, acc[i][j]);
}

// Stages m, 1 / l and di of 128 rows from `first` into shared memory.
__device__ __forceinline__ void stage_stats(float* ms, float* ils, float* dis,
                                            const float* m, const float* l,
                                            const float* di, long long first, int tid) {
  if (tid < kBlock) {
    ms[tid] = m[first + tid];
    ils[tid] = 1.f / l[first + tid];
    dis[tid] = di[first + tid];
  }
}

// Each block makes the 128 output columns from c0 = 128 blockIdx.z; the
// scores and the softmax statistics are recomputed for each, identically,
// and the first writes l and m.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_f32(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, float* __restrict__ l_out, float* __restrict__ m_out,
              Layout lay, int H, int N, int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ps = reinterpret_cast<float*>(smem);
  float* Ac = Ps + kBlock * kFP;
  float* Bc = Ac + kFK * kFP;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long q0 = static_cast<long long>(blockIdx.x) * kBlock;
  const int c0 = blockIdx.z * kDO;
  const int nk = N / kBlock;
  const T* qb = rows_of(q, lay.t[0], b, h, q0);

  float acc[8][8];
  zero88(acc);
  float m_run[8], l_run[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }
  for (int j = 0; j < nk; ++j) {
    const long long k0 = static_cast<long long>(j) * kBlock;
    float s[8][8];
    zero88(s);
    nt_product_f32<T, D>(s, qb, lay.t[0].n, rows_of(k, lay.t[1], b, h, k0), lay.t[1].n, Ac,
                         Bc, tid, d);
    float corr[8], inv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        s[i][jj] = __fmul_rn(s[i][jj], scale);
        mx = fmaxf(mx, s[i][jj]);
      }
      mx = half_warp_max(mx);
      if (nk > 1) mx = fmaxf(m_run[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        s[i][jj] = expf(__fsub_rn(s[i][jj], mx));
        sum += s[i][jj];
      }
      sum = half_warp_sum(sum);
      if (nk == 1) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) s[i][jj] = s[i][jj] / sum;
        corr[i] = 0.f;
        inv[i] = 1.f;
        l_run[i] = sum;
      } else {
        const float l_corr = __fmul_rn(expf(__fsub_rn(m_run[i], mx)), l_run[i]);
        const float l_next = __fadd_rn(sum, l_corr);
        inv[i] = l_next == 0.f ? 1.f : 1.f / l_next;
        corr[i] = __fmul_rn(l_corr, inv[i]);
        l_run[i] = l_next;
      }
      m_run[i] = mx;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) Ps[(ty + 16 * i) * kFP + tx + 16 * jj] = s[i][jj];
    }
    float oc[8][8];
    zero88(oc);
    p_product_f32(oc, Ps, rows_of(v, lay.t[2], b, h, k0) + c0, lay.t[2].n, Bc, tid);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        acc[i][jj] = __fadd_rn(__fmul_rn(acc[i][jj], corr[i]), __fmul_rn(oc[i][jj], inv[i]));
  }
  const Strides so = lay.t[3];
  store_f32(o + b * so.b + h * so.h + q0 * so.n + c0, so.n, acc, tid);
  if (tx == 0 && blockIdx.z == 0) {
    const long long row = static_cast<long long>(blockIdx.y) * N + q0 + ty;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      l_out[row + 16 * i] = l_run[i];
      m_out[row + 16 * i] = m_run[i];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_f32(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const float* __restrict__ l, const float* __restrict__ m,
             const T* __restrict__ dout, const float* __restrict__ di, T* __restrict__ dq,
             Layout lay, int H, int N, int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ps = reinterpret_cast<float*>(smem);
  float* Ac = Ps + kBlock * kFP;
  float* Bc = Ac + kFK * kFP;
  float* ms = Bc + kFK * kFP;
  float* ils = ms + kBlock;
  float* dis = ils + kBlock;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long q0 = static_cast<long long>(blockIdx.x) * kBlock;
  const int c0 = blockIdx.z * kDO;
  const int nk = N / kBlock;
  stage_stats(ms, ils, dis, m, l, di, static_cast<long long>(blockIdx.y) * N + q0, tid);
  __syncthreads();
  const T* qb = rows_of(q, lay.t[0], b, h, q0);
  const T* ob = rows_of(dout, lay.t[3], b, h, q0);

  float acc[8][8];
  zero88(acc);
  for (int j = 0; j < nk; ++j) {
    const long long k0 = static_cast<long long>(j) * kBlock;
    const T* kb = rows_of(k, lay.t[1], b, h, k0);
    float s[8][8];
    zero88(s);
    nt_product_f32<T, D>(s, qb, lay.t[0].n, kb, lay.t[1].n, Ac, Bc, tid, d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        Ps[r * kFP + tx + 16 * jj] =
            __fmul_rn(expf(__fsub_rn(__fmul_rn(s[i][jj], scale), ms[r])), ils[r]);
    }
    zero88(s);  // now dp = do v^T
    nt_product_f32<T, D>(s, ob, lay.t[3].n, rows_of(v, lay.t[2], b, h, k0), lay.t[2].n, Ac,
                         Bc, tid, d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float* p = &Ps[r * kFP + tx + 16 * jj];
        *p = __fmul_rn(__fmul_rn(__fsub_rn(s[i][jj], dis[r]), *p), scale);
      }
    }
    p_product_f32(acc, Ps, kb + c0, lay.t[1].n, Bc, tid);
  }
  const int dd = D ? D : d;
  store_f32(dq + (static_cast<long long>(blockIdx.y) * N + q0) * dd + c0, dd, acc, tid);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_f32(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const float* __restrict__ l, const float* __restrict__ m,
              const T* __restrict__ dout, const float* __restrict__ di, T* __restrict__ dk,
              T* __restrict__ dv, Layout lay, int H, int N, int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ps = reinterpret_cast<float*>(smem);
  float* Ac = Ps + kBlock * kFP;
  float* Bc = Ac + kFK * kFP;
  float* ms = Bc + kFK * kFP;
  float* ils = ms + kBlock;
  float* dis = ils + kBlock;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long k0 = static_cast<long long>(blockIdx.x) * kBlock;
  const int c0 = blockIdx.z * kDO;
  const T* kb = rows_of(k, lay.t[1], b, h, k0);
  const T* vb = rows_of(v, lay.t[2], b, h, k0);

  float dk_acc[8][8], dv_acc[8][8];
  zero88(dk_acc);
  zero88(dv_acc);
  for (int i0 = 0; i0 < N; i0 += kBlock) {
    __syncthreads();  // every thread is done with the last block's stats
    stage_stats(ms, ils, dis, m, l, di, static_cast<long long>(blockIdx.y) * N + i0, tid);
    __syncthreads();
    const T* qb = rows_of(q, lay.t[0], b, h, i0);
    const T* ob = rows_of(dout, lay.t[3], b, h, i0);
    float s[8][8];  // s^T = k q^T: rows keys, columns queries
    zero88(s);
    nt_product_f32<T, D>(s, kb, lay.t[1].n, qb, lay.t[0].n, Ac, Bc, tid, d);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = tx + 16 * jj;
        Ps[(ty + 16 * i) * kFP + c] =
            __fmul_rn(expf(__fsub_rn(__fmul_rn(s[i][jj], scale), ms[c])), ils[c]);
      }
    p_product_f32(dv_acc, Ps, ob + c0, lay.t[3].n, Bc, tid);
    zero88(s);  // now dp^T = v do^T
    nt_product_f32<T, D>(s, vb, lay.t[2].n, ob, lay.t[3].n, Ac, Bc, tid, d);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = tx + 16 * jj;
        float* p = &Ps[(ty + 16 * i) * kFP + c];
        *p = __fmul_rn(__fmul_rn(__fsub_rn(s[i][jj], dis[c]), *p), scale);
      }
    p_product_f32(dk_acc, Ps, qb + c0, lay.t[0].n, Bc, tid);
  }
  const int dd = D ? D : d;
  const long long out = (static_cast<long long>(blockIdx.y) * N + k0) * dd + c0;
  store_f32(dk + out, dd, dk_acc, tid);
  store_f32(dv + out, dd, dv_acc, tid);
}

// --- launchers -------------------------------------------------------------------
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// D: any multiple of 128 (the output slices a block makes: gridDim.z).
bool bad_shape(int B, int H, int N, int D, int dtype) {
  return B <= 0 || H <= 0 || N < kBlock || N % kBlock || D < kDO || D % kDO ||
         D / kDO > 65535 || static_cast<long long>(B) * H > 65535 ||
         (dtype != kFloat32 && dtype != kBFloat16);
}

// The wgmma kernels' head dims; every other multiple of 128 (and float32
// at every D) runs the FFMA kernels, at D > 256 as their D = 0 instance.
bool wgmma_dim(int D) { return D == 128 || D == 256; }

Layout layout_of(const long long* strides) {
  Layout lay;
  for (int i = 0; i < 4; ++i) lay.t[i] = Strides{strides[3 * i], strides[3 * i + 1],
                                                  strides[3 * i + 2]};
  return lay;
}

// A 4-D tensor map (D, N, H, B) of a [B, H, N, D] bf16 tensor over its
// element strides, boxes of 64 columns x `rows` rows.
bool head_map(CUtensorMap* map, const void* base, const Strides& st, int B, int H, int N, int D,
              int rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(N),
                            static_cast<uint64_t>(H), static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(st.n) * sizeof(bf16),
                               static_cast<uint64_t>(st.h) * sizeof(bf16),
                               static_cast<uint64_t>(st.b) * sizeof(bf16)};
  const uint32_t box[4] = {64, static_cast<uint32_t>(rows), 1, 1};
  return hopper::make_map(map, base, 4, dims, strides, box);
}

// K5f in bf16: a map of each of q, k and v, boxes of 64 columns x 128 rows.
template <int D>
cudaError_t launch_fwd_bf16(const void* q, const void* k, const void* v, void* o, float* l,
                            float* m, const Layout& lay, int B, int H, int N, float scale,
                            cudaStream_t s) {
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    if (!head_map(&maps[i], bases[i], lay.t[i], B, H, N, D, kBlock)) {
      return cudaErrorInvalidValue;
    }
  }
  const cudaError_t err = allow_smem(flash_fwd_wgmma<D>, Fwd<D>::kSmem);
  if (err != cudaSuccess) return err;
  flash_fwd_wgmma<D><<<dim3(N / kBlock, B * H), kFwdThreads, Fwd<D>::kSmem, s>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(o), l, m, lay.t[3], H, N, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_fwd_f32(const void* q, const void* k, const void* v, void* o, float* l,
                           float* m, const Layout& lay, int B, int H, int N, int d, float scale,
                           cudaStream_t s) {
  const cudaError_t err = allow_smem(flash_fwd_f32<T, D>, kF32Smem);
  if (err != cudaSuccess) return err;
  flash_fwd_f32<T, D><<<dim3(N / kBlock, B * H, d / kDO), kThreads, kF32Smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), l, m, lay, H, N, d, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v, const float* l,
                           const float* m, const void* dout, const float* di, void* dk,
                           void* dv, const Layout& lay, int B, int H, int N, int d, float scale,
                           cudaStream_t s) {
  const cudaError_t err = allow_smem(flash_dkv_f32<T, D>, kF32Smem);
  if (err != cudaSuccess) return err;
  flash_dkv_f32<T, D><<<dim3(N / kBlock, B * H, d / kDO), kThreads, kF32Smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), l, m,
      static_cast<const T*>(dout), di, static_cast<T*>(dk), static_cast<T*>(dv), lay, H, N,
      d, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const float* l,
                       const float* m, const void* dout, const float* di, void* dk, void* dv,
                       const Layout& lay, int B, int H, int N, float scale, int dtype,
                       cudaStream_t s) {
  if (dtype != kBFloat16) {
    return launch_dkv_f32<float, D>(q, k, v, l, m, dout, di, dk, dv, lay, B, H, N, D, scale, s);
  }
  const dim3 grid(N / kBlock, B * H, D / kDO);
  // q and do in boxes of 64 rows, k and v of 128
  CUtensorMap maps[4];
  const void* bases[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const int rows = i == 1 || i == 2 ? kBlock : kSub;
    if (!head_map(&maps[i], bases[i], lay.t[i], B, H, N, D, rows)) return cudaErrorInvalidValue;
  }
  const cudaError_t err = allow_smem(flash_dkv_wgmma<D>, Dkv<D>::kSmem);
  if (err != cudaSuccess) return err;
  flash_dkv_wgmma<D><<<grid, kFwdThreads, Dkv<D>::kSmem, s>>>(
      maps[0], maps[1], maps[2], maps[3], l, m, di, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, N, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v, const float* l,
                          const float* m, const void* dout, const float* di, void* dq,
                          const Layout& lay, int B, int H, int N, int d, float scale,
                          cudaStream_t s) {
  const cudaError_t err = allow_smem(flash_dq_f32<T, D>, kF32Smem);
  if (err != cudaSuccess) return err;
  flash_dq_f32<T, D><<<dim3(N / kBlock, B * H, d / kDO), kThreads, kF32Smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), l, m,
      static_cast<const T*>(dout), di, static_cast<T*>(dq), lay, H, N, d, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const float* l,
                      const float* m, const void* dout, const float* di, void* dq,
                      const Layout& lay, int B, int H, int N, float scale, int dtype,
                      cudaStream_t s) {
  if (dtype != kBFloat16) {
    return launch_dq_f32<float, D>(q, k, v, l, m, dout, di, dq, lay, B, H, N, D, scale, s);
  }
  const dim3 grid(N / kBlock, B * H, D / kDO);
  // q and do in boxes of 128 rows, k and v of 64
  CUtensorMap maps[4];
  const void* bases[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const int rows = i == 1 || i == 2 ? kSub : kBlock;
    if (!head_map(&maps[i], bases[i], lay.t[i], B, H, N, D, rows)) return cudaErrorInvalidValue;
  }
  const cudaError_t err = allow_smem(flash_dq_wgmma<D>, Dq<D>::kSmem);
  if (err != cudaSuccess) return err;
  flash_dq_wgmma<D><<<grid, kFwdThreads, Dq<D>::kSmem, s>>>(
      maps[0], maps[1], maps[2], maps[3], l, m, di, static_cast<bf16*>(dq), H, N, scale);
  return cudaGetLastError();
}

}  // namespace

// K5f. q, k, v [B, H, N, D] through `strides` (host array: b, h, n of q, k,
// v, then o); o out in the same dtype through its strides; l, m float32
// [B, H, N] out. D a multiple of 128, N a multiple of 128; dtype 1 = bf16,
// 0 = float32. Returns cudaGetLastError() (cudaErrorInvalidValue if
// cuTensorMapEncodeTiled refuses a tensor map).
extern "C" int htrvt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                               void* l, void* m, const long long* strides, float scale,
                               int B, int H, int N, int D, int dtype, void* stream) {
  if (bad_shape(B, H, N, D, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout lay = layout_of(strides);
  float* lo = static_cast<float*>(l);
  float* mo = static_cast<float*>(m);
  cudaError_t err;
  if (!wgmma_dim(D)) {
    err = dtype == kBFloat16
              ? launch_fwd_f32<bf16, 0>(q, k, v, o, lo, mo, lay, B, H, N, D, scale, s)
              : launch_fwd_f32<float, 0>(q, k, v, o, lo, mo, lay, B, H, N, D, scale, s);
  } else if (dtype == kBFloat16) {
    err = D == 128 ? launch_fwd_bf16<128>(q, k, v, o, lo, mo, lay, B, H, N, scale, s)
                   : launch_fwd_bf16<256>(q, k, v, o, lo, mo, lay, B, H, N, scale, s);
  } else {
    err = D == 128 ? launch_fwd_f32<float, 128>(q, k, v, o, lo, mo, lay, B, H, N, D, scale, s)
                   : launch_fwd_f32<float, 256>(q, k, v, o, lo, mo, lay, B, H, N, D, scale, s);
  }
  return static_cast<int>(err);
}

// K5dkv. q, k, v, do [B, H, N, D] through `strides` (b, h, n of q, k, v,
// do); l, m, di float32 [B, H, N]; dk, dv contiguous [B, H, N, D] out.
// Returns cudaGetLastError().
extern "C" int htrvt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* l, const void* m, const void* dout,
                                   const void* di, void* dk, void* dv,
                                   const long long* strides, float scale, int B, int H,
                                   int N, int D, int dtype, void* stream) {
  if (bad_shape(B, H, N, D, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout lay = layout_of(strides);
  const float* lf = static_cast<const float*>(l);
  const float* mf = static_cast<const float*>(m);
  const float* df = static_cast<const float*>(di);
  cudaError_t err;
  if (!wgmma_dim(D)) {
    err = dtype == kBFloat16
              ? launch_dkv_f32<bf16, 0>(q, k, v, lf, mf, dout, df, dk, dv, lay, B, H, N, D,
                                        scale, s)
              : launch_dkv_f32<float, 0>(q, k, v, lf, mf, dout, df, dk, dv, lay, B, H, N, D,
                                         scale, s);
  } else {
    err = D == 128
              ? launch_dkv<128>(q, k, v, lf, mf, dout, df, dk, dv, lay, B, H, N, scale, dtype, s)
              : launch_dkv<256>(q, k, v, lf, mf, dout, df, dk, dv, lay, B, H, N, scale, dtype, s);
  }
  return static_cast<int>(err);
}

// K5dq. The inputs of K5dkv; dq contiguous [B, H, N, D] out. Returns
// cudaGetLastError().
extern "C" int htrvt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* l, const void* m, const void* dout,
                                  const void* di, void* dq, const long long* strides,
                                  float scale, int B, int H, int N, int D, int dtype,
                                  void* stream) {
  if (bad_shape(B, H, N, D, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout lay = layout_of(strides);
  const float* lf = static_cast<const float*>(l);
  const float* mf = static_cast<const float*>(m);
  const float* df = static_cast<const float*>(di);
  cudaError_t err;
  if (!wgmma_dim(D)) {
    err = dtype == kBFloat16
              ? launch_dq_f32<bf16, 0>(q, k, v, lf, mf, dout, df, dq, lay, B, H, N, D, scale, s)
              : launch_dq_f32<float, 0>(q, k, v, lf, mf, dout, df, dq, lay, B, H, N, D, scale,
                                        s);
  } else {
    err = D == 128 ? launch_dq<128>(q, k, v, lf, mf, dout, df, dq, lay, B, H, N, scale, dtype, s)
                   : launch_dq<256>(q, k, v, lf, mf, dout, df, dq, lay, B, H, N, scale, dtype, s);
  }
  return static_cast<int>(err);
}
