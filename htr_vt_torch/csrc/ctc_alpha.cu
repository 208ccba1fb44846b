// CTC alpha recursion (log-space forward pass) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel htr_vt_tpu/ops/ctc_pallas.py:_alpha_kernel
// (:55-85), which ctc_pallas.py:_run_recursion (:168-187) launches. The
// plain PyTorch version of the same recursion, with the same inputs and
// output, is htr_vt_torch/ops/ctc_cuda.py:ctc_alpha_reference.
//
//   alpha[b,0,s] = start2[b,s] && valid[b,s] ? lp[b,0,s] : NEG
//   alpha[b,t,s] = valid[b,s]
//       ? max(logaddexp3(alpha[t-1,s], alpha[t-1,s-1],
//                        noskip[b,s] ? NEG : alpha[t-1,s-2]) + lp[b,t,s], NEG)
//       : NEG
//   with lp[b,t,s] = logp[b, t, z[b,s]] and NEG = -1e30.
//
// What bounds it on this card: latency. Each sample is T - 1 dependent
// frames; at B=128, T=128, S=193 the kernel moves 17.9 MB (0.0054 ms at
// 3.35 TB/s), far less than the frames' chain takes. The design
// (ctc_recursion.cuh) keeps the chain to the arithmetic, one warp shuffle
// and the frame's barrier: one block per sample; thread i holds states
// [i K, i K + K) in registers and takes s-1 and s-2 from the lanes below by
// __shfl_up_sync, and a warp's lanes 0 and 1 from the edge values that the
// warp below left in shared memory before the barrier; the emissions come
// from time panels that thread 0 stages in shared memory by cp.async.bulk.

#include "ctc_recursion.cuh"

namespace {

using ctc::kNeg;

template <int K>
__global__ void __launch_bounds__(32 * ctc::kMaxWarps)
ctc_alpha_kernel(const float* __restrict__ logp, const int* __restrict__ z,
                 const bool* __restrict__ noskip, const bool* __restrict__ valid,
                 const bool* __restrict__ start2, float* __restrict__ alpha,
                 int T, int C, int S, int P) {
  // The thread's second-to-last state, and how far below its copy lies in
  // the lanes (for K = 1 it is the last state of two lanes below).
  constexpr int kSecond = K >= 2 ? K - 2 : 0;
  constexpr int kSecondLanes = K >= 2 ? 1 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const ctc::Shared sh(smem, warps);
  const size_t b = blockIdx.x;
  const float* lp = logp + b * T * C;
  ctc::init_shared(sh, warps);
  __syncthreads();
  if (threadIdx.x == 0) {
    ctc::copy_panel(sh, lp, 0, T, C, P, false);
    if (P < T) ctc::copy_panel(sh, lp, 1, T, C, P, false);
  }

  const int s0 = threadIdx.x * K;
  ctc::States<K> st;
  st.load(z + b * S, noskip + b * S, valid + b * S, start2 + b * S, s0, -1, S, C);
  float* out_t = alpha + b * T * S;
  ctc::Panels panels;
  // Warp w's edge for the warp above, in slot w + 1: its lane 31's last
  // state (near) and the state before that (far); warp w reads slot w. The
  // frame's parity swaps the two pointers of each.
  float* my_edge = sh.edge + 2 * (w + 1);
  float* my_edge_next = my_edge + 2 * (warps + 2);
  const float* below = sh.edge + 2 * w;
  const float* below_next = below + 2 * (warps + 2);

  float a[K];
  {  // frame 0
    const float* em = panels.next(sh, lp, T, C, P, false);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      a[k] = (st.edge >> k & 1u) ? em[st.cls[k]] : kNeg;
      if (s0 + k < S) out_t[s0 + k] = a[k];
    }
  }
  // x1, x2: the last and second-to-last states below the thread's first.
  float x1 = __shfl_up_sync(0xffffffffu, a[K - 1], 1);
  float x2 = __shfl_up_sync(0xffffffffu, a[kSecond], kSecondLanes);
  if (lane == 31) {
    my_edge[0] = a[K - 1];
    my_edge[1] = K >= 2 ? a[kSecond] : x1;
  }
  // The next frame's emissions, if its row is in shared memory already.
  float e[K];
  bool have = panels.ready();
  if (have) {
#pragma unroll
    for (int k = 0; k < K; ++k) e[k] = panels.row[st.cls[k]];
  }
  __syncthreads();

  const int c_reg = ctc::in_register(C), s_reg = ctc::in_register(S);
  for (int t = 1; t < T; ++t) {
    const float* em = panels.next(sh, lp, T, c_reg, P, false);
    if (!have) {
#pragma unroll
      for (int k = 0; k < K; ++k) e[k] = em[st.cls[k]];
    }
    // s-1 and s-2 of the thread's first state, from frame t-1.
    const float near = below[0], far = below[1];
    const float l1 = lane == 0 ? near : x1;
    const float l2 = lane == 0 ? far : (K == 1 && lane == 1 ? near : x2);
    out_t += s_reg;
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {  // in place: a[k-1], a[k-2] are still frame t-1's
      const int s = s0 + k;
      const float p1 = k >= 1 ? a[k >= 1 ? k - 1 : 0] : l1;
      const float p2 = k >= 2 ? a[k >= 2 ? k - 2 : 0] : (k == 1 ? l1 : l2);
      const float a1 = (st.step >> k & 1u) ? p1 : kNeg;
      const float a2 = (st.skip >> k & 1u) ? p2 : kNeg;
      const float v = fmaxf(ctc::logaddexp3(a[k], a1, a2) + e[k], kNeg);
      a[k] = (st.valid >> k & 1u) ? v : kNeg;
      if (s < s_reg) out_t[s] = a[k];
    }
    x1 = __shfl_up_sync(0xffffffffu, a[K - 1], 1);
    x2 = __shfl_up_sync(0xffffffffu, a[kSecond], kSecondLanes);
    if (lane == 31) {
      my_edge_next[0] = a[K - 1];
      my_edge_next[1] = K >= 2 ? a[kSecond] : x1;
    }
    have = panels.ready();
    if (have) {
#pragma unroll
      for (int k = 0; k < K; ++k) e[k] = panels.row[st.cls[k]];
    }
    // The edges of frame t are in, and every read of frame t-1's is done
    // before frame t+1 overwrites them: one barrier a frame suffices.
    __syncthreads();
    float* mine = my_edge;
    my_edge = my_edge_next;
    my_edge_next = mine;
    const float* theirs = below;
    below = below_next;
    below_next = theirs;
  }
}

using Kernel = void (*)(const float*, const int*, const bool*, const bool*,
                        const bool*, float*, int, int, int, int);
const Kernel kKernels[] = {ctc_alpha_kernel<1>, ctc_alpha_kernel<2>,
                           ctc_alpha_kernel<4>, ctc_alpha_kernel<8>};

// The strided path (ctc_recursion.cuh): thread i takes the states i, i +
// blockDim.x, ...; frame t reads frame t-1's values back from `alpha`, which
// the barrier at the end of frame t-1 has made visible to the block.
__global__ void __launch_bounds__(ctc::kStridedThreads)
ctc_alpha_strided(const float* __restrict__ logp, const int* __restrict__ z,
                  const bool* __restrict__ noskip, const bool* __restrict__ valid,
                  const bool* __restrict__ start2, float* __restrict__ alpha, int T,
                  int C, int S) {
  const size_t b = blockIdx.x;
  const float* lp = logp + b * T * C;
  const int* zb = z + b * S;
  const bool* noskip_b = noskip + b * S;
  const bool* valid_b = valid + b * S;
  const bool* start2_b = start2 + b * S;
  float* out = alpha + b * T * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int cls = min(max(zb[s], 0), C - 1);
    out[s] = start2_b[s] && valid_b[s] ? lp[cls] : kNeg;
  }
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    const float* prev = out + size_t(t - 1) * S;
    float* cur = out + size_t(t) * S;
    const float* em = lp + size_t(t) * C;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float a1 = s >= 1 ? prev[s - 1] : kNeg;
      const float a2 = s >= 2 && !noskip_b[s] ? prev[s - 2] : kNeg;
      const float v =
          fmaxf(ctc::logaddexp3(prev[s], a1, a2) + em[min(max(zb[s], 0), C - 1)], kNeg);
      cur[s] = valid_b[s] ? v : kNeg;
    }
    __syncthreads();
  }
}

}  // namespace

// logp [B,T,C] f32, z [B,S] i32, noskip/valid/start2 [B,S] bool (one byte),
// alpha [B,T,S] f32 out; all contiguous on one device. `panel` frames a
// panel and `per_thread` states a thread (0: the strided path) come from
// ops/ctc_cuda.py:recursion_geometry. Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// geometry the kernel does not take.
extern "C" int htrvt_ctc_alpha(const void* logp, const void* z,
                               const void* noskip, const void* valid,
                               const void* start2, void* alpha, int B, int T,
                               int C, int S, int panel, int per_thread,
                               void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const ctc::Launch l = ctc::launch_shape(T, C, S, panel, per_thread);
  if (l.threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (l.variant < 0) {
    return ctc::launch(ctc_alpha_strided, B, l, stream, static_cast<const float*>(logp),
                       static_cast<const int*>(z), static_cast<const bool*>(noskip),
                       static_cast<const bool*>(valid), static_cast<const bool*>(start2),
                       static_cast<float*>(alpha), T, C, S);
  }
  return ctc::launch(kKernels[l.variant], B, l, stream,
                     static_cast<const float*>(logp), static_cast<const int*>(z),
                     static_cast<const bool*>(noskip),
                     static_cast<const bool*>(valid),
                     static_cast<const bool*>(start2),
                     static_cast<float*>(alpha), T, C, S, panel);
}

extern "C" const char* htrvt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
