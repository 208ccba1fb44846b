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
// sample is T dependent steps, each ending in one block barrier; at B=128,
// T=128, S=193 it writes the 12.6 MB beta cube and gathers about as much
// from logp, far below what HBM moves in the time the steps take. Making it
// fast is later work: fusing the posterior exp(alpha + beta - total) and the
// scatter onto the classes into this kernel (the [B,T,S] beta cube would
// then never be written), several samples per block, and warp shuffles in
// place of the shared-memory rows and barriers. This version is the simple,
// correct one.
//
// Design: one block per sample walks t from T-1 down to 0, threads striding
// over the S extended-label states, so any S works. Two rows of `term` live
// in shared memory (about 1.5 KB at S=193): frame t reads the row of t+1
// (its own state and the next two, written by other threads) and writes the
// row of t into the other buffer, so one __syncthreads() per frame
// suffices. The TPU kernel's reverse time panels and its VMEM carry of
// `beta + lp` across a sequential grid axis become this loop. The emission
// is gathered here, with the class index clamped as in ctc_alpha.cu.
// expf/logf, no fast math, the same operation order as the plain version.

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;

__device__ __forceinline__ float logaddexp3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float out = m + logf(expf(a - m) + expf(b - m) + expf(c - m));
  return fmaxf(out, kNeg);
}

// Class index of state s, clamped so that a label outside [0, C) cannot
// read outside its logp row (the wrapper's contract is z in [0, C)).
__device__ __forceinline__ int class_of(const int* zb, int s, int C) {
  return min(max(zb[s], 0), C - 1);
}

__global__ void ctc_beta_kernel(const float* __restrict__ logp,
                                const int* __restrict__ z,
                                const bool* __restrict__ noskip,
                                const bool* __restrict__ valid,
                                const bool* __restrict__ endm,
                                float* __restrict__ beta,
                                int T, int C, int S) {
  extern __shared__ float rows[];  // two term rows of S floats
  float* next = rows;              // term of frame t+1, read in frame t
  float* cur = rows + S;           // term of frame t, written in frame t

  const size_t b = blockIdx.x;
  const float* lp = logp + b * T * C;
  const int* zb = z + b * S;
  const bool* noskip_b = noskip + b * S;
  const bool* valid_b = valid + b * S;
  const bool* endm_b = endm + b * S;
  float* out = beta + b * T * S;

  {
    const float* lp_t = lp + static_cast<size_t>(T - 1) * C;
    float* out_t = out + static_cast<size_t>(T - 1) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float v = (endm_b[s] && valid_b[s]) ? 0.0f : kNeg;
      out_t[s] = v;
      next[s] = v + lp_t[class_of(zb, s, C)];
    }
  }
  __syncthreads();

  for (int t = T - 2; t >= 0; --t) {
    const float* lp_t = lp + static_cast<size_t>(t) * C;
    float* out_t = out + static_cast<size_t>(t) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      float v = kNeg;
      if (valid_b[s]) {
        const float b1 = s + 1 < S ? next[s + 1] : kNeg;
        const float b2 = (s + 2 < S && !noskip_b[s + 2]) ? next[s + 2] : kNeg;
        v = logaddexp3(next[s], b1, b2);
      }
      out_t[s] = v;
      cur[s] = v + lp_t[class_of(zb, s, C)];
    }
    // Every read of `next` in this frame is done before the frame after
    // overwrites it; with two rows one barrier per frame suffices.
    __syncthreads();
    float* tmp = next;
    next = cur;
    cur = tmp;
  }
}

}  // namespace

// logp [B,T,C] f32, z [B,S] i32, noskip/valid/endm [B,S] bool (one byte),
// beta [B,T,S] f32 out; all contiguous on one device. Launches on `stream`
// and returns cudaGetLastError() (0 on success). T >= 1 and S >= 1.
extern "C" int htrvt_ctc_beta(const void* logp, const void* z,
                              const void* noskip, const void* valid,
                              const void* endm, void* beta, int B, int T,
                              int C, int S, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  int threads = (S + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = 2 * static_cast<size_t>(S) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ctc_beta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ctc_beta_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logp), static_cast<const int*>(z),
      static_cast<const bool*>(noskip), static_cast<const bool*>(valid),
      static_cast<const bool*>(endm), static_cast<float*>(beta), T, C, S);
  return static_cast<int>(cudaGetLastError());
}
