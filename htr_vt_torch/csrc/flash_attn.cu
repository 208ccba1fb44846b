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
// Shapes: q, k, v, o, do [B, H, N, D] with D = 128 and N a multiple of 128,
// read through element strides (b, h, n) with the last dim contiguous, so
// the strided views of a fused qkv projection need no copy; dq, dk, dv
// contiguous [B, H, N, D]; l, m, di float32 [B, H, N]. T = the element type
// (bf16, or float32), every sum float32:
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
// the library does (__fmul_rn / __fadd_rn: no FMA contraction).
//
// What bounds them on this card. At the 2048-px serving shape [128, 6, 512,
// 128] K5f does 4 * B*H*N^2*D = 103.1 GFLOP (0.104 ms at the H100's 989
// TFLOP/s bf16 dense) and moves 402.7 MB (0.120 ms at 3.35 TB/s): bytes by
// a little, so the kernel has to read each byte once and keep the tensor
// cores busy. At the 2048-px training shape [64, 6, 512, 128] K5dkv (8 *
// B*H*N^2*D = 103.1 GFLOP, 0.104 ms) and K5dq (6 * B*H*N^2*D = 77.3 GFLOP,
// 0.078 ms) are bound by operations. The plain version writes the float32
// score matrix, [B, H, N, N]: 805 MB a layer at the serving shape.
//
// Design. One block of 8 warps per (b, h, 128-row tile): K5f and K5dq own
// 128 queries and walk the key blocks; K5dkv owns 128 keys and walks the
// query blocks, so dk and dv need no atomics and dq stays a kernel of its
// own, as in the library: two calls give equal bits. Each warp owns 16 of
// the 128 rows. Tiles arrive in shared memory by cp.async (row pitch 136
// bf16: ldmatrix without bank conflicts); bf16 products run on the tensor
// cores with mma.sync m16n8k16 (float32 accumulate) from ldmatrix
// fragments, and the score tile, the running max and sum, the accumulator
// and the probabilities stay in registers: a score tile's accumulator
// fragment is the next product's A fragment once packed to bf16, so nothing
// of size [N, N] leaves the chip. K5dkv computes the transposed tiles (s^T =
// k q^T, dp^T = v do^T) so that p^T and ds^T are A fragments too, and walks
// the queries 64 at a time (K5dq the keys), which keeps two float32
// accumulators (dk, dv) and two 64-wide score tiles within the register
// file. float32 runs a 128 x 128 FFMA tile (8 x 8 outputs a thread) with
// the probabilities in shared memory (no TF32).
// wgmma, TMA and a warp-specialised pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

constexpr int kD = 128;          // head_dim
constexpr int kBlock = 128;      // queries or keys a block owns; the library's blocks
constexpr int kThreads = 256;    // 8 warps
constexpr int kWarpRows = 16;    // a warp's rows: one m16 tile
constexpr int kPitch = kD + 8;   // bf16 row pitch in shared memory (272 bytes)
constexpr int kSub = 64;         // K5dkv's queries, K5dq's keys, per step
constexpr int kFP = 129;         // float32 row pitch in shared memory
constexpr int kFK = 32;          // float32 staging chunk

constexpr size_t kTile = sizeof(bf16) * kBlock * kPitch;  // 34,816 bytes
constexpr size_t kSubTile = sizeof(bf16) * kSub * kPitch;
constexpr size_t kFwdSmem = 3 * kTile;                    // q, k, v
constexpr size_t kDqSmem = 4 * kTile;                     // q, do, k, v
constexpr size_t kDkvSmem = 2 * kTile + 2 * kSubTile + 3 * sizeof(float) * kSub;
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
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a * b for a 16x16 bf16 A fragment and a 16x8 B fragment.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

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

template <int kN>
__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// kRows rows of 128 bf16 from `src` (rows `stride` elements apart) to
// shared memory [kRows][kPitch], 16 bytes a copy, asynchronously.
template <int kRows>
__device__ __forceinline__ void copy_rows(bf16 (*dst)[kPitch], const bf16* src,
                                          long long stride, int tid) {
  constexpr int kVecs = kD / 8;
#pragma unroll
  for (int i = 0; i < kRows * kVecs / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / kVecs, c = (idx % kVecs) * 8;
    cp_async16(&dst[r][c], src + r * stride + c);
  }
}

// acc[nt] (16 rows x 8 kNT columns) += A B^T over the 128 of D, where A is
// rows a0..a0+15 of As and B rows b0..b0 + 8 kNT - 1 of Bs, both [rows][D]:
// a score tile q k^T (or its transpose k q^T).
template <int kNT>
__device__ __forceinline__ void rows_dot_rows(float (*acc)[4], bf16 (*As)[kPitch], int a0,
                                              bf16 (*Bs)[kPitch], int b0, int lane) {
#pragma unroll
  for (int kk = 0; kk < kD; kk += 16) {
    uint32_t af[4];
    ldsm_x4(af, &As[a0 + (lane & 15)][kk + (lane >> 4) * 8]);
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      uint32_t bfr[4];
      ldsm_x4(bfr, &Bs[b0 + np * 16 + (lane & 7) + ((lane >> 4) << 3)]
                      [kk + ((lane >> 3) & 1) * 8]);
      mma_bf16(acc[2 * np], af, bfr[0], bfr[1]);
      mma_bf16(acc[2 * np + 1], af, bfr[2], bfr[3]);
    }
  }
}

// A score tile's accumulators (16 rows x 16 kKS columns, float32) as the
// bf16 A fragments of the product over those columns.
template <int kKS>
__device__ __forceinline__ void to_a_fragments(uint32_t (*pa)[4], float (*s)[4]) {
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
    pa[ks][0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
    pa[ks][1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
    pa[ks][2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
    pa[ks][3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
  }
}

// acc[nt] (16 rows x 8 kNT columns from column c0) += P B, P the 16 x 16 kKS
// A fragments `pa`, B rows b0.. of Bs [rows][D]: p v, p^T do, ds^T q, ds k.
template <int kKS, int kNT>
__device__ __forceinline__ void frags_dot_rows(float (*acc)[4], uint32_t (*pa)[4],
                                               bf16 (*Bs)[kPitch], int b0, int c0,
                                               int lane) {
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      uint32_t bfr[4];
      ldsm_x4_trans(bfr, &Bs[b0 + ks * 16 + (lane & 15)][c0 + np * 16 + (lane >> 4) * 8]);
      mma_bf16(acc[2 * np], pa[ks], bfr[0], bfr[1]);
      mma_bf16(acc[2 * np + 1], pa[ks], bfr[2], bfr[3]);
    }
  }
}

// Stores a warp's 16 x 128 float32 accumulators as bf16 rows (row stride
// `stride`), two columns a store.
__device__ __forceinline__ void store_rows(bf16* out, long long stride, float (*acc)[4],
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(out + g * stride + c) = pack_bf16(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<uint32_t*>(out + (g + 8) * stride + c) =
        pack_bf16(acc[nt][2], acc[nt][3]);
  }
}

// --- K5f, bf16 on the tensor cores -----------------------------------------
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ l_out,
              float* __restrict__ m_out, Layout lay, int H, int N, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16 (*Qs)[kPitch] = reinterpret_cast<bf16 (*)[kPitch]>(smem);
  bf16 (*Ks)[kPitch] = Qs + kBlock;
  bf16 (*Vs)[kPitch] = Ks + kBlock;
  const int tid = threadIdx.x, lane = tid & 31, r0 = (tid >> 5) * kWarpRows;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long q0 = static_cast<long long>(blockIdx.x) * kBlock;
  const int nk = N / kBlock;

  copy_rows<kBlock>(Qs, rows_of(q, lay.t[0], b, h, q0), lay.t[0].n, tid);
  cp_async_commit();

  float acc[kD / 8][4];
  zero<kD / 8>(acc);
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  for (int j = 0; j < nk; ++j) {
    __syncthreads();  // every warp is done with the last block's k and v
    copy_rows<kBlock>(Ks, rows_of(k, lay.t[1], b, h, static_cast<long long>(j) * kBlock),
                      lay.t[1].n, tid);
    cp_async_commit();
    copy_rows<kBlock>(Vs, rows_of(v, lay.t[2], b, h, static_cast<long long>(j) * kBlock),
                      lay.t[2].n, tid);
    cp_async_commit();
    cp_async_wait<1>();  // q and k have landed; v may still be in flight
    __syncthreads();

    float s[kBlock / 8][4];
    zero<kBlock / 8>(s);
    rows_dot_rows<kBlock / 8>(s, Qs, r0, Ks, 0, lane);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = __fmul_rn(s[nt][e], scale);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float corr[2], inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      if (nk > 1) mx[i] = fmaxf(m_run[i], mx[i]);  // m'
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(__fsub_rn(s[nt][e], mx[e >> 1]));
        sum[e >> 1] += s[nt][e];
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
      for (int nt = 0; nt < kBlock / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = s[nt][e] / sum[e >> 1];
    }
    uint32_t pa[kBlock / 16][4];
    to_a_fragments<kBlock / 16>(pa, s);
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = __fmul_rn(acc[nt][e], corr[e >> 1]);
    cp_async_wait<0>();
    __syncthreads();
    // (p v) / l' in two halves of D, so one float32 [16, 64] partial is live
#pragma unroll
    for (int dh = 0; dh < 2; ++dh) {
      float oc[kD / 16][4];
      zero<kD / 16>(oc);
      frags_dot_rows<kBlock / 16, kD / 16>(oc, pa, Vs, 0, dh * (kD / 2), lane);
#pragma unroll
      for (int nt = 0; nt < kD / 16; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[dh * (kD / 16) + nt][e] =
              __fadd_rn(acc[dh * (kD / 16) + nt][e], __fmul_rn(oc[nt][e], inv[e >> 1]));
    }
  }
  const Strides so = lay.t[3];
  store_rows(o + b * so.b + h * so.h + (q0 + r0) * so.n, so.n, acc, lane);
  if ((lane & 3) == 0) {
    const long long row = static_cast<long long>(blockIdx.y) * N + q0 + r0 + (lane >> 2);
    l_out[row] = l_run[0];
    l_out[row + 8] = l_run[1];
    m_out[row] = m_run[0];
    m_out[row + 8] = m_run[1];
  }
}

// --- K5dq, bf16 ----------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const float* __restrict__ l,
             const float* __restrict__ m, const bf16* __restrict__ dout,
             const float* __restrict__ di, bf16* __restrict__ dq, Layout lay, int H, int N,
             float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16 (*Qs)[kPitch] = reinterpret_cast<bf16 (*)[kPitch]>(smem);
  bf16 (*Os)[kPitch] = Qs + kBlock;  // do
  bf16 (*Ks)[kPitch] = Os + kBlock;
  bf16 (*Vs)[kPitch] = Ks + kBlock;
  const int tid = threadIdx.x, lane = tid & 31, r0 = (tid >> 5) * kWarpRows;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long q0 = static_cast<long long>(blockIdx.x) * kBlock;
  const int nk = N / kBlock;

  copy_rows<kBlock>(Qs, rows_of(q, lay.t[0], b, h, q0), lay.t[0].n, tid);
  copy_rows<kBlock>(Os, rows_of(dout, lay.t[3], b, h, q0), lay.t[3].n, tid);
  cp_async_commit();
  // this thread's two rows: m, 1 / l and di
  const long long row = static_cast<long long>(blockIdx.y) * N + q0 + r0 + (lane >> 2);
  const float mr[2] = {m[row], m[row + 8]};
  const float il[2] = {1.f / l[row], 1.f / l[row + 8]};
  const float dr[2] = {di[row], di[row + 8]};

  float acc[kD / 8][4];
  zero<kD / 8>(acc);
  for (int j = 0; j < nk; ++j) {
    __syncthreads();
    copy_rows<kBlock>(Ks, rows_of(k, lay.t[1], b, h, static_cast<long long>(j) * kBlock),
                      lay.t[1].n, tid);
    copy_rows<kBlock>(Vs, rows_of(v, lay.t[2], b, h, static_cast<long long>(j) * kBlock),
                      lay.t[2].n, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kh = 0; kh < kBlock / kSub; ++kh) {
      float s[kSub / 8][4], dp[kSub / 8][4];
      zero<kSub / 8>(s);
      zero<kSub / 8>(dp);
      rows_dot_rows<kSub / 8>(s, Qs, r0, Ks, kh * kSub, lane);
      rows_dot_rows<kSub / 8>(dp, Os, r0, Vs, kh * kSub, lane);
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float p = __fmul_rn(expf(__fsub_rn(__fmul_rn(s[nt][e], scale), mr[i])), il[i]);
          dp[nt][e] = __fmul_rn(__fmul_rn(__fsub_rn(dp[nt][e], dr[i]), p), scale);
        }
      uint32_t pa[kSub / 16][4];
      to_a_fragments<kSub / 16>(pa, dp);
      frags_dot_rows<kSub / 16, kD / 8>(acc, pa, Ks, kh * kSub, 0, lane);
    }
  }
  store_rows(dq + (static_cast<long long>(blockIdx.y) * N + q0 + r0) * kD, kD, acc, lane);
}

// --- K5dkv, bf16 ---------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const float* __restrict__ l,
              const float* __restrict__ m, const bf16* __restrict__ dout,
              const float* __restrict__ di, bf16* __restrict__ dk, bf16* __restrict__ dv,
              Layout lay, int H, int N, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16 (*Ks)[kPitch] = reinterpret_cast<bf16 (*)[kPitch]>(smem);
  bf16 (*Vs)[kPitch] = Ks + kBlock;
  bf16 (*Qs)[kPitch] = Vs + kBlock;  // kSub rows
  bf16 (*Os)[kPitch] = Qs + kSub;    // do, kSub rows
  float* ms = reinterpret_cast<float*>(Os + kSub);
  float* ils = ms + kSub;
  float* dis = ils + kSub;
  const int tid = threadIdx.x, lane = tid & 31, r0 = (tid >> 5) * kWarpRows;
  const int t = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long k0 = static_cast<long long>(blockIdx.x) * kBlock;
  const long long stats = static_cast<long long>(blockIdx.y) * N;

  copy_rows<kBlock>(Ks, rows_of(k, lay.t[1], b, h, k0), lay.t[1].n, tid);
  copy_rows<kBlock>(Vs, rows_of(v, lay.t[2], b, h, k0), lay.t[2].n, tid);
  cp_async_commit();

  float dk_acc[kD / 8][4], dv_acc[kD / 8][4];
  zero<kD / 8>(dk_acc);
  zero<kD / 8>(dv_acc);
  for (int i0 = 0; i0 < N; i0 += kSub) {
    __syncthreads();  // every warp is done with the last step's q and do
    copy_rows<kSub>(Qs, rows_of(q, lay.t[0], b, h, i0), lay.t[0].n, tid);
    copy_rows<kSub>(Os, rows_of(dout, lay.t[3], b, h, i0), lay.t[3].n, tid);
    cp_async_commit();
    if (tid < kSub) {
      ms[tid] = m[stats + i0 + tid];
      ils[tid] = 1.f / l[stats + i0 + tid];
      dis[tid] = di[stats + i0 + tid];
    }
    cp_async_wait<0>();
    __syncthreads();

    // p^T: rows = this warp's keys, columns = the step's queries
    float st[kSub / 8][4];
    zero<kSub / 8>(st);
    rows_dot_rows<kSub / 8>(st, Ks, r0, Qs, 0, lane);
#pragma unroll
    for (int nt = 0; nt < kSub / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);
        st[nt][e] = __fmul_rn(expf(__fsub_rn(__fmul_rn(st[nt][e], scale), ms[c])), ils[c]);
      }
    uint32_t pa[kSub / 16][4];
    to_a_fragments<kSub / 16>(pa, st);
    frags_dot_rows<kSub / 16, kD / 8>(dv_acc, pa, Os, 0, 0, lane);
    // ds^T = p^T (dp^T - di) scale, dp^T = v do^T
    float dpt[kSub / 8][4];
    zero<kSub / 8>(dpt);
    rows_dot_rows<kSub / 8>(dpt, Vs, r0, Os, 0, lane);
#pragma unroll
    for (int nt = 0; nt < kSub / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);
        dpt[nt][e] = __fmul_rn(__fmul_rn(__fsub_rn(dpt[nt][e], dis[c]), st[nt][e]), scale);
      }
    to_a_fragments<kSub / 16>(pa, dpt);
    frags_dot_rows<kSub / 16, kD / 8>(dk_acc, pa, Qs, 0, 0, lane);
  }
  const long long out = (static_cast<long long>(blockIdx.y) * N + k0 + r0) * kD;
  store_rows(dk + out, kD, dk_acc, lane);
  store_rows(dv + out, kD, dv_acc, lane);
}

// --- float32 on FFMA -----------------------------------------------------------
// A thread owns the 8 x 8 outputs (ty + 16 i, tx + 16 j) of a 128 x 128
// tile, ty = tid / 16, tx = tid % 16: the 16 threads of a row group are one
// half-warp, so row reductions are shuffles.

// acc[i][j] += sum_d A[ty + 16 i, d] * Bt[tx + 16 j, d] for two [128, D]
// row sets (rows sa, sb elements apart), staged 32 of D at a time,
// transposed, in Ac and Bc.
__device__ __forceinline__ void nt_product_f32(float acc[8][8], const float* A,
                                               long long sa, const float* Bt,
                                               long long sb, float* Ac, float* Bc,
                                               int tid) {
  const int tx = tid & 15, ty = tid >> 4;
  for (int d0 = 0; d0 < kD; d0 += kFK) {
#pragma unroll
    for (int i = 0; i < kBlock * kFK / 4 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (kFK / 4), c = (idx % (kFK / 4)) * 4;
      const float4 a = *reinterpret_cast<const float4*>(A + r * sa + d0 + c);
      const float4 bb = *reinterpret_cast<const float4*>(Bt + r * sb + d0 + c);
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

// acc[i][j] += sum_r P[ty + 16 i, r] * B[r, tx + 16 j] over the 128 rows r
// of B ([128, D], rows sb elements apart), P in shared memory [128][kFP];
// B staged 32 rows at a time in Bc.
__device__ __forceinline__ void p_product_f32(float acc[8][8], const float* Ps,
                                              const float* B, long long sb, float* Bc,
                                              int tid) {
  const int tx = tid & 15, ty = tid >> 4;
  for (int r0 = 0; r0 < kBlock; r0 += kFK) {
#pragma unroll
    for (int i = 0; i < kFK * kD / 4 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (kD / 4), c = (idx % (kD / 4)) * 4;
      const float4 bb = *reinterpret_cast<const float4*>(B + (r0 + r) * sb + c);
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
      for (int i = 0; i < 8; ++i) a[i] = Ps[(ty + 16 * i) * kFP + r0 + r];
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

__device__ __forceinline__ void store_f32(float* out, long long stride, float acc[8][8],
                                          int tid) {
  const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) out[(ty + 16 * i) * stride + tx + 16 * j] = acc[i][j];
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

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ l_out,
              float* __restrict__ m_out, Layout lay, int H, int N, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ps = reinterpret_cast<float*>(smem);
  float* Ac = Ps + kBlock * kFP;
  float* Bc = Ac + kFK * kFP;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long q0 = static_cast<long long>(blockIdx.x) * kBlock;
  const int nk = N / kBlock;
  const float* qb = rows_of(q, lay.t[0], b, h, q0);

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
    nt_product_f32(s, qb, lay.t[0].n, rows_of(k, lay.t[1], b, h, k0), lay.t[1].n, Ac, Bc,
                   tid);
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
    p_product_f32(oc, Ps, rows_of(v, lay.t[2], b, h, k0), lay.t[2].n, Bc, tid);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        acc[i][jj] = __fadd_rn(__fmul_rn(acc[i][jj], corr[i]), __fmul_rn(oc[i][jj], inv[i]));
  }
  const Strides so = lay.t[3];
  store_f32(o + b * so.b + h * so.h + q0 * so.n, so.n, acc, tid);
  if (tx == 0) {
    const long long row = static_cast<long long>(blockIdx.y) * N + q0 + ty;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      l_out[row + 16 * i] = l_run[i];
      m_out[row + 16 * i] = m_run[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ l,
             const float* __restrict__ m, const float* __restrict__ dout,
             const float* __restrict__ di, float* __restrict__ dq, Layout lay, int H, int N,
             float scale) {
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
  const int nk = N / kBlock;
  stage_stats(ms, ils, dis, m, l, di, static_cast<long long>(blockIdx.y) * N + q0, tid);
  __syncthreads();
  const float* qb = rows_of(q, lay.t[0], b, h, q0);
  const float* ob = rows_of(dout, lay.t[3], b, h, q0);

  float acc[8][8];
  zero88(acc);
  for (int j = 0; j < nk; ++j) {
    const long long k0 = static_cast<long long>(j) * kBlock;
    const float* kb = rows_of(k, lay.t[1], b, h, k0);
    float s[8][8];
    zero88(s);
    nt_product_f32(s, qb, lay.t[0].n, kb, lay.t[1].n, Ac, Bc, tid);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        Ps[r * kFP + tx + 16 * jj] =
            __fmul_rn(expf(__fsub_rn(__fmul_rn(s[i][jj], scale), ms[r])), ils[r]);
    }
    zero88(s);  // now dp = do v^T
    nt_product_f32(s, ob, lay.t[3].n, rows_of(v, lay.t[2], b, h, k0), lay.t[2].n, Ac, Bc,
                   tid);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float* p = &Ps[r * kFP + tx + 16 * jj];
        *p = __fmul_rn(__fmul_rn(__fsub_rn(s[i][jj], dis[r]), *p), scale);
      }
    }
    p_product_f32(acc, Ps, kb, lay.t[1].n, Bc, tid);
  }
  store_f32(dq + (static_cast<long long>(blockIdx.y) * N + q0) * kD, kD, acc, tid);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ l,
              const float* __restrict__ m, const float* __restrict__ dout,
              const float* __restrict__ di, float* __restrict__ dk, float* __restrict__ dv,
              Layout lay, int H, int N, float scale) {
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
  const float* kb = rows_of(k, lay.t[1], b, h, k0);
  const float* vb = rows_of(v, lay.t[2], b, h, k0);

  float dk_acc[8][8], dv_acc[8][8];
  zero88(dk_acc);
  zero88(dv_acc);
  for (int i0 = 0; i0 < N; i0 += kBlock) {
    __syncthreads();  // every thread is done with the last block's stats
    stage_stats(ms, ils, dis, m, l, di, static_cast<long long>(blockIdx.y) * N + i0, tid);
    __syncthreads();
    const float* qb = rows_of(q, lay.t[0], b, h, i0);
    const float* ob = rows_of(dout, lay.t[3], b, h, i0);
    float s[8][8];  // s^T = k q^T: rows keys, columns queries
    zero88(s);
    nt_product_f32(s, kb, lay.t[1].n, qb, lay.t[0].n, Ac, Bc, tid);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = tx + 16 * jj;
        Ps[(ty + 16 * i) * kFP + c] =
            __fmul_rn(expf(__fsub_rn(__fmul_rn(s[i][jj], scale), ms[c])), ils[c]);
      }
    p_product_f32(dv_acc, Ps, ob, lay.t[3].n, Bc, tid);
    zero88(s);  // now dp^T = v do^T
    nt_product_f32(s, vb, lay.t[2].n, ob, lay.t[3].n, Ac, Bc, tid);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = tx + 16 * jj;
        float* p = &Ps[(ty + 16 * i) * kFP + c];
        *p = __fmul_rn(__fmul_rn(__fsub_rn(s[i][jj], dis[c]), *p), scale);
      }
    p_product_f32(dk_acc, Ps, qb, lay.t[0].n, Bc, tid);
  }
  const long long out = (static_cast<long long>(blockIdx.y) * N + k0) * kD;
  store_f32(dk + out, kD, dk_acc, tid);
  store_f32(dv + out, kD, dv_acc, tid);
}

// --- launchers -------------------------------------------------------------------
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool bad_shape(int B, int H, int N, int D, int dtype) {
  return B <= 0 || H <= 0 || N < kBlock || N % kBlock || D != kD ||
         static_cast<long long>(B) * H > 65535 || (dtype != kFloat32 && dtype != kBFloat16);
}

Layout layout_of(const long long* strides) {
  Layout lay;
  for (int i = 0; i < 4; ++i) lay.t[i] = Strides{strides[3 * i], strides[3 * i + 1],
                                                  strides[3 * i + 2]};
  return lay;
}

}  // namespace

// K5f. q, k, v [B, H, N, D] through `strides` (host array: b, h, n of q, k,
// v, then o); o out in the same dtype through its strides; l, m float32
// [B, H, N] out. D = 128, N a multiple of 128; dtype 1 = bf16, 0 =
// float32. Returns cudaGetLastError().
extern "C" int htrvt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                               void* l, void* m, const long long* strides, float scale,
                               int B, int H, int N, int D, int dtype, void* stream) {
  if (bad_shape(B, H, N, D, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout lay = layout_of(strides);
  const dim3 grid(N / kBlock, B * H);
  float* lo = static_cast<float*>(l);
  float* mo = static_cast<float*>(m);
  cudaError_t err;
  if (dtype == kBFloat16) {
    err = allow_smem(flash_fwd_mma, kFwdSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_mma<<<grid, kThreads, kFwdSmem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), lo, mo, lay, H, N, scale);
  } else {
    err = allow_smem(flash_fwd_f32, kF32Smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_f32<<<grid, kThreads, kF32Smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lo, mo, lay, H, N, scale);
  }
  return static_cast<int>(cudaGetLastError());
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
  const dim3 grid(N / kBlock, B * H);
  const float* lf = static_cast<const float*>(l);
  const float* mf = static_cast<const float*>(m);
  const float* df = static_cast<const float*>(di);
  cudaError_t err;
  if (dtype == kBFloat16) {
    err = allow_smem(flash_dkv_mma, kDkvSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_dkv_mma<<<grid, kThreads, kDkvSmem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        lf, mf, static_cast<const bf16*>(dout), df, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), lay, H, N, scale);
  } else {
    err = allow_smem(flash_dkv_f32, kF32Smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_dkv_f32<<<grid, kThreads, kF32Smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), lf, mf, static_cast<const float*>(dout), df,
        static_cast<float*>(dk), static_cast<float*>(dv), lay, H, N, scale);
  }
  return static_cast<int>(cudaGetLastError());
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
  const dim3 grid(N / kBlock, B * H);
  const float* lf = static_cast<const float*>(l);
  const float* mf = static_cast<const float*>(m);
  const float* df = static_cast<const float*>(di);
  cudaError_t err;
  if (dtype == kBFloat16) {
    err = allow_smem(flash_dq_mma, kDqSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_dq_mma<<<grid, kThreads, kDqSmem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        lf, mf, static_cast<const bf16*>(dout), df, static_cast<bf16*>(dq), lay, H, N, scale);
  } else {
    err = allow_smem(flash_dq_f32, kF32Smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_dq_f32<<<grid, kThreads, kF32Smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), lf, mf, static_cast<const float*>(dout), df,
        static_cast<float*>(dq), lay, H, N, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
