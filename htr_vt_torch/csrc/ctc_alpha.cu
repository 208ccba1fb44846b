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
// What bounds it on this card: latency, not bandwidth. Each sample is T
// dependent steps, and every step ends in one block barrier. At B=128,
// T=128, S=193 the kernel writes only the 12.6 MB alpha cube (and gathers
// about the same from logp), far below what HBM moves in the time the
// 127 barrier-separated steps take. Making it fast (several samples per
// block, warp shuffles in place of the shared-memory rows and barriers) is
// a later change; this version is the simple, correct one.
//
// Design: one block per sample, threads striding over the S extended-label
// states, so any S works. Two alpha rows live in shared memory (about
// 1.5 KB at S=193), one __syncthreads() per frame. The TPU kernel's time
// panels and VMEM carry across a sequential grid axis become a loop over t
// inside the block. The emission logp[b, t, z[b,s]] is gathered here; the
// TPU path's one-hot matmul gather was a workaround for the TPU. expf/logf,
// no fast math, so the kernel agrees with the float32 plain version to
// rounding.

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

__global__ void ctc_alpha_kernel(const float* __restrict__ logp,
                                 const int* __restrict__ z,
                                 const bool* __restrict__ noskip,
                                 const bool* __restrict__ valid,
                                 const bool* __restrict__ start2,
                                 float* __restrict__ alpha,
                                 int T, int C, int S) {
  extern __shared__ float rows[];  // two alpha rows of S floats
  float* prev = rows;
  float* cur = rows + S;

  const size_t b = blockIdx.x;
  const float* lp = logp + b * T * C;
  const int* zb = z + b * S;
  const bool* noskip_b = noskip + b * S;
  const bool* valid_b = valid + b * S;
  const bool* start2_b = start2 + b * S;
  float* out = alpha + b * T * S;

  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const float v = (start2_b[s] && valid_b[s]) ? lp[class_of(zb, s, C)] : kNeg;
    prev[s] = v;
    out[s] = v;
  }
  __syncthreads();

  for (int t = 1; t < T; ++t) {
    const float* lp_t = lp + static_cast<size_t>(t) * C;
    float* out_t = out + static_cast<size_t>(t) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      float v = kNeg;
      if (valid_b[s]) {
        const float a1 = s >= 1 ? prev[s - 1] : kNeg;
        const float a2 = (s >= 2 && !noskip_b[s]) ? prev[s - 2] : kNeg;
        v = fmaxf(logaddexp3(prev[s], a1, a2) + lp_t[class_of(zb, s, C)], kNeg);
      }
      cur[s] = v;
      out_t[s] = v;
    }
    // Every read of prev in this frame is done before the next frame
    // overwrites it; with two rows one barrier per frame suffices.
    __syncthreads();
    float* tmp = prev;
    prev = cur;
    cur = tmp;
  }
}

}  // namespace

// logp [B,T,C] f32, z [B,S] i32, noskip/valid/start2 [B,S] bool (one byte),
// alpha [B,T,S] f32 out; all contiguous on one device. Launches on `stream`
// and returns cudaGetLastError() (0 on success). T >= 1 and S >= 1.
extern "C" int htrvt_ctc_alpha(const void* logp, const void* z,
                               const void* noskip, const void* valid,
                               const void* start2, void* alpha, int B, int T,
                               int C, int S, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  int threads = (S + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = 2 * static_cast<size_t>(S) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ctc_alpha_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ctc_alpha_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logp), static_cast<const int*>(z),
      static_cast<const bool*>(noskip), static_cast<const bool*>(valid),
      static_cast<const bool*>(start2), static_cast<float*>(alpha), T, C, S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* htrvt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
