// CTC beta recursion (log-space backward pass) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel htr_vt_tpu/ops/ctc_pallas.py:_beta_kernel
// (:88-127), which ctc_pallas.py:_ctc_bwd (:262-272) launches through
// _run_recursion(reverse_time=True). The plain PyTorch version of the same
// recursion, with the same inputs and output, is
// htr_vt_torch/ops/ctc_cuda.py:ctc_beta_reference.
//
// beta leaves out the emission of its own frame:
//   beta[b,T-1,s] = endm[b,s] && valid[b,s] ? 0 : NEG
//   term[s]       = beta[b,t+1,s] + lp[b,t+1,s]
//   beta[b,t,s]   = valid[b,s]
//       ? logaddexp3(term[s], term[s+1], noskip[b,s+2] ? NEG : term[s+2])
//       : NEG                 (indices past S-1 read NEG)
//   with lp[b,t,s] = logp[b, t, z[b,s]] and NEG = -1e30.
// Leaving state s by a skip lands in s+2, so the skip is allowed iff
// noskip[s+2] is false: the mask index is s+2, not s.
//
// What bounds it on this card: latency, as for the alpha kernel. Each
// sample is T - 1 dependent frames; at B=128, T=128, S=193 it moves 17.9 MB
// (0.0054 ms at 3.35 TB/s), far less than the frames' chain takes. The
// design is the alpha kernel's mirrored (ctc_recursion.cuh): one block per
// sample walks t from T-1 down to 0; thread i holds the `term` values of
// states [i K, i K + K) in registers (the TPU kernel's VMEM carry of
// beta + lp across its reverse panels) and takes s+1 and s+2 from the lanes
// above by __shfl_down_sync, and a warp's lanes 31 and 30 from the edge
// values that the warp above left in shared memory before the frame's
// barrier; the emissions come from time panels, taken from the end, that
// thread 0 stages in shared memory by cp.async.bulk. Fusing the posterior
// exp(alpha + beta - total) in here is no part of the TPU kernel and stays
// outside.

#include "ctc_recursion.cuh"

namespace {

using ctc::kNeg;

template <int K>
__global__ void __launch_bounds__(32 * ctc::kMaxWarps)
ctc_beta_kernel(const float* __restrict__ logp, const int* __restrict__ z,
                const bool* __restrict__ noskip, const bool* __restrict__ valid,
                const bool* __restrict__ endm, float* __restrict__ beta,
                int T, int C, int S, int P) {
  // The thread's second state, and how far above its copy lies in the
  // lanes (for K = 1 it is the first state of two lanes above).
  constexpr int kSecond = K >= 2 ? 1 : 0;
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
    ctc::copy_panel(sh, lp, 0, T, C, P, true);
    if (P < T) ctc::copy_panel(sh, lp, 1, T, C, P, true);
  }

  const int s0 = threadIdx.x * K;
  ctc::States<K> st;
  st.load(z + b * S, noskip + b * S, valid + b * S, endm + b * S, s0, 1, S, C);
  float* out_t = beta + (b * T + T - 1) * S;
  ctc::Panels panels;
  // Warp w's edge for the warp below, in slot w + 1: its lane 0's first
  // term (near) and the one after it (far); warp w reads slot w + 2. The
  // frame's parity swaps the two pointers of each.
  float* my_edge = sh.edge + 2 * (w + 1);
  float* my_edge_next = my_edge + 2 * (warps + 2);
  const float* above = sh.edge + 2 * (w + 2);
  const float* above_next = above + 2 * (warps + 2);

  float term[K];
  {  // frame T-1 (walk step 0)
    const float* em = panels.next(sh, lp, T, C, P, true);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float v = (st.edge >> k & 1u) ? 0.0f : kNeg;
      if (s0 + k < S) out_t[s0 + k] = v;
      term[k] = v + em[st.cls[k]];
    }
  }
  // d1, d2: the first and second terms above the thread's last.
  float d1 = __shfl_down_sync(0xffffffffu, term[0], 1);
  float d2 = __shfl_down_sync(0xffffffffu, term[kSecond], kSecondLanes);
  if (lane == 0) {
    my_edge[0] = term[0];
    my_edge[1] = K >= 2 ? term[kSecond] : d1;
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
  for (int m = 1; m < T; ++m) {
    const float* em = panels.next(sh, lp, T, c_reg, P, true);
    if (!have) {
#pragma unroll
      for (int k = 0; k < K; ++k) e[k] = em[st.cls[k]];
    }
    // s+1 and s+2 of the thread's last state, from frame t+1.
    const float near = above[0], far = above[1];
    const float r1 = lane == 31 ? near : d1;
    const float r2 = lane == 31 ? far : (K == 1 && lane == 30 ? near : d2);
    out_t -= s_reg;
#pragma unroll
    for (int k = 0; k < K; ++k) {  // in place: term[k+1], term[k+2] are still frame t+1's
      const int s = s0 + k;
      const float p1 = k + 1 < K ? term[k + 1 < K ? k + 1 : 0] : r1;
      const float p2 = k + 2 < K ? term[k + 2 < K ? k + 2 : 0] : (k + 2 == K ? r1 : r2);
      const float b1 = (st.step >> k & 1u) ? p1 : kNeg;
      const float b2 = (st.skip >> k & 1u) ? p2 : kNeg;
      const float v = ctc::logaddexp3(term[k], b1, b2);
      const float bv = (st.valid >> k & 1u) ? v : kNeg;
      if (s < s_reg) out_t[s] = bv;
      term[k] = bv + e[k];
    }
    d1 = __shfl_down_sync(0xffffffffu, term[0], 1);
    d2 = __shfl_down_sync(0xffffffffu, term[kSecond], kSecondLanes);
    if (lane == 0) {
      my_edge_next[0] = term[0];
      my_edge_next[1] = K >= 2 ? term[kSecond] : d1;
    }
    have = panels.ready();
    if (have) {
#pragma unroll
      for (int k = 0; k < K; ++k) e[k] = panels.row[st.cls[k]];
    }
    // The edges of this frame are in, and every read of the frame before's
    // is done before the next frame overwrites them: one barrier a frame.
    __syncthreads();
    float* mine = my_edge;
    my_edge = my_edge_next;
    my_edge_next = mine;
    const float* theirs = above;
    above = above_next;
    above_next = theirs;
  }
}

using Kernel = void (*)(const float*, const int*, const bool*, const bool*,
                        const bool*, float*, int, int, int, int);
const Kernel kKernels[] = {ctc_beta_kernel<1>, ctc_beta_kernel<2>,
                           ctc_beta_kernel<4>, ctc_beta_kernel<8>};

// The strided path (ctc_recursion.cuh): thread i takes the states i, i +
// blockDim.x, ...; frame t reads frame t+1's values back from `beta`, which
// the barrier at the end of frame t+1 has made visible to the block, and
// adds their emissions as the register path does (term = beta + lp).
__global__ void __launch_bounds__(ctc::kStridedThreads)
ctc_beta_strided(const float* __restrict__ logp, const int* __restrict__ z,
                 const bool* __restrict__ noskip, const bool* __restrict__ valid,
                 const bool* __restrict__ endm, float* __restrict__ beta, int T, int C,
                 int S) {
  const size_t b = blockIdx.x;
  const float* lp = logp + b * T * C;
  const int* zb = z + b * S;
  const bool* noskip_b = noskip + b * S;
  const bool* valid_b = valid + b * S;
  const bool* endm_b = endm + b * S;
  float* out = beta + b * T * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    out[size_t(T - 1) * S + s] = endm_b[s] && valid_b[s] ? 0.0f : kNeg;
  }
  __syncthreads();
  for (int t = T - 2; t >= 0; --t) {
    const float* next = out + size_t(t + 1) * S;
    float* cur = out + size_t(t) * S;
    const float* em = lp + size_t(t + 1) * C;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float t0 = next[s] + em[min(max(zb[s], 0), C - 1)];
      const float b1 = s + 1 < S ? next[s + 1] + em[min(max(zb[s + 1], 0), C - 1)] : kNeg;
      const float b2 = s + 2 < S && !noskip_b[s + 2]
                           ? next[s + 2] + em[min(max(zb[s + 2], 0), C - 1)]
                           : kNeg;
      const float v = ctc::logaddexp3(t0, b1, b2);
      cur[s] = valid_b[s] ? v : kNeg;
    }
    __syncthreads();
  }
}

}  // namespace

// logp [B,T,C] f32, z [B,S] i32, noskip/valid/endm [B,S] bool (one byte),
// beta [B,T,S] f32 out; all contiguous on one device. `panel` and
// `per_thread` as for htrvt_ctc_alpha. Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// geometry the kernel does not take.
extern "C" int htrvt_ctc_beta(const void* logp, const void* z,
                              const void* noskip, const void* valid,
                              const void* endm, void* beta, int B, int T,
                              int C, int S, int panel, int per_thread,
                              void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const ctc::Launch l = ctc::launch_shape(T, C, S, panel, per_thread);
  if (l.threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (l.variant < 0) {
    return ctc::launch(ctc_beta_strided, B, l, stream, static_cast<const float*>(logp),
                       static_cast<const int*>(z), static_cast<const bool*>(noskip),
                       static_cast<const bool*>(valid), static_cast<const bool*>(endm),
                       static_cast<float*>(beta), T, C, S);
  }
  return ctc::launch(kKernels[l.variant], B, l, stream,
                     static_cast<const float*>(logp), static_cast<const int*>(z),
                     static_cast<const bool*>(noskip),
                     static_cast<const bool*>(valid),
                     static_cast<const bool*>(endm), static_cast<float*>(beta),
                     T, C, S, panel);
}
