// Shared parts of the CTC alpha and beta kernels (ctc_alpha.cu, ctc_beta.cu)
// for Hopper, sm_90a.
//
// Both recursions are one block per sample walking T dependent frames; what
// bounds them is that chain, not bandwidth. Each frame of a state is three
// expf, one logf and a few maxima and adds on its own value and its two
// neighbours' values of the frame before (alpha: s-1 and s-2; beta: s+1 and
// s+2). The design keeps everything else short and off device memory:
//
// - Registers, not shared-memory rows: thread i holds K consecutive states
//   [i K, i K + K) and their values; neighbours within a warp come by
//   __shfl_up/down_sync. Only the two values at a warp's edge cross to the
//   next warp, through shared memory (double-buffered by frame parity; a
//   slot holding NEG stands beyond each end of the block, so every warp
//   reads its neighbour's slot without a branch), so one barrier a frame
//   remains: the recursion needs no other exchange.
// - Emissions staged ahead in shared memory: thread 0 brings the sample's
//   logp rows in time panels of P frames (the TPU kernel's time panels,
//   ctc_pallas.py:_run_recursion) by cp.async.bulk into two buffers, each
//   with an mbarrier that the copy completes; panel q + 1 is in flight
//   while panel q is read. A state gathers logp[b, t, z[b, s]] from the
//   panel, for the next frame before the frame's barrier where that frame
//   lies in the same panel. A bulk copy needs 16-byte aligned ends, so it
//   copies the aligned superset of the panel's rows and the readers skip
//   its first `offset` floats (C = 6 puts most panels off a 16-byte
//   boundary); the superset never leaves the 16-byte granules of the
//   panel's first and last bytes.
// - Each state's class and flags are loaded once into registers.
//
// So a frame's loop reads no device memory. The geometry comes from the
// wrapper (ops/ctc_cuda.py:recursion_geometry): K states a thread (a power
// of two up to kMaxPerThread) and P frames a panel.
//
// Past what one block's registers hold (S > kMaxPerThread * 32 * kMaxWarps
// = 8192 states), or where two panels of logp rows do not fit in shared
// memory, the same kernels' files have a strided path (K = 0 from the
// wrapper): one block of up to 1024 threads a sample strides over the
// states, reads the previous frame's values back from the [B, T, S] output
// it writes anyway (L2 holds that row), gathers the emissions from logp
// directly, and keeps one barrier a frame. Its arithmetic is the register
// path's, in the same order, so both give the plain version's bits.

#pragma once

#include <stdint.h>

#include "hopper.cuh"

namespace ctc {

constexpr float kNeg = -1e30f;
constexpr int kMaxWarps = 32;
constexpr int kMaxPerThread = 8;
constexpr int kStridedThreads = 1024;  // the strided path's block
constexpr int kBuffers = 2;  // panel buffers

// The plain version's three-way log-sum-exp (ops/ctc.py:logaddexp3), in its
// order of operations; expf/logf, no fast math, so the kernels and the
// plain versions give equal bits.
__device__ __forceinline__ float logaddexp3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float out = m + logf(expf(a - m) + expf(b - m) + expf(c - m));
  return fmaxf(out, kNeg);
}

// A copy of x that the compiler must keep in a register. Without it ptxas
// reloads kernel parameters from the constant bank inside the frame loop,
// and those loads' latency lands on the frame's chain.
__device__ __forceinline__ int in_register(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// --- the geometry, shared by the launcher and the kernels --------------------
__host__ __device__ __forceinline__ int panel_floats(int P, int C) {
  return (P * C + 8 + 3) / 4 * 4;  // the rows plus the aligned superset's slack
}

// The mbarriers and the edge values, before the panels.
__host__ __device__ __forceinline__ size_t fixed_bytes(int warps) {
  return kBuffers * sizeof(uint64_t) + size_t(2) * (warps + 2) * 2 * sizeof(float);
}

// Frames [t0, t0 + n) of panel q (walk order: forwards for alpha, from the
// end for beta).
__device__ __forceinline__ void panel_frames(int q, int T, int P, bool reverse, int& t0,
                                             int& n) {
  if (reverse) {
    const int hi = T - q * P;
    t0 = max(0, hi - P);
    n = hi - t0;
  } else {
    t0 = q * P;
    n = min(P, T - t0);
  }
}

// Where panel q's rows start in global memory, rounded down to 16 bytes,
// and the floats from there to the first row.
__device__ __forceinline__ const float* panel_source(const float* lp, int t0, int C,
                                                     int& offset) {
  const float* src = lp + size_t(t0) * C;
  const float* lo = reinterpret_cast<const float*>(reinterpret_cast<uintptr_t>(src) &
                                                   ~uintptr_t(15));
  offset = int(src - lo);
  return lo;
}

// --- the block's shared memory ------------------------------------------------
struct Shared {
  uint64_t* full;  // [kBuffers]: the panel in the buffer has landed
  float* edge;     // [2][warps + 2][2]: by frame parity, the warps' edge
                   // values in slots 1..warps, NEG in slots 0 and warps + 1
  float* panels;   // [kBuffers][panel_floats]

  __device__ Shared(unsigned char* base, int warps) {
    full = reinterpret_cast<uint64_t*>(base);
    edge = reinterpret_cast<float*>(full + kBuffers);
    panels = reinterpret_cast<float*>(base + fixed_bytes(warps));
  }
};

// The barriers (thread 0) and the NEG edge slots; a __syncthreads follows.
__device__ __forceinline__ void init_shared(const Shared& sh, int warps) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kBuffers; ++i) hopper::mbar_init(&sh.full[i], 1);
    hopper::mbar_fence_init();
  }
  if (threadIdx.x < 8) {  // slots 0 and warps + 1 of both parities
    const int parity = threadIdx.x / 4, slot = threadIdx.x / 2 % 2 ? warps + 1 : 0;
    sh.edge[(parity * (warps + 2) + slot) * 2 + threadIdx.x % 2] = kNeg;
  }
}

// Thread 0: start copying panel q into buffer q % kBuffers. Every thread has
// passed a barrier since it last read that buffer.
__device__ __forceinline__ void copy_panel(const Shared& sh, const float* lp, int q, int T,
                                           int C, int P, bool reverse) {
  int t0, n, offset;
  panel_frames(q, T, P, reverse, t0, n);
  const float* lo = panel_source(lp, t0, C, offset);
  const uint32_t bytes = uint32_t((offset + n * C) * 4 + 15) / 16 * 16;
  const int buf = q % kBuffers;
  hopper::fence_proxy_async();
  hopper::mbar_expect_tx(&sh.full[buf], bytes);
  hopper::bulk_load(sh.panels + buf * panel_floats(P, C), lo, bytes, &sh.full[buf]);
}

// The block's walk through the panels: next() gives the row of the next
// frame in walk order. Panels 0 and 1 are started before the walk; entering
// panel q >= 1, thread 0 starts the copy of panel q + 1 into the buffer of
// panel q - 1, and every thread waits for panel q.
struct Panels {
  int q = -1;                  // the panel being read
  int left = 0;                // its frames not yet read
  const float* row = nullptr;  // the next frame's row

  // Whether the next frame's row is in shared memory already.
  __device__ __forceinline__ bool ready() const { return left > 0; }

  __device__ __forceinline__ const float* next(const Shared& sh, const float* lp, int T, int C,
                                               int P, bool reverse) {
    if (left == 0) {
      ++q;
      if (threadIdx.x == 0 && q >= 1 && q + 1 < (T + P - 1) / P)
        copy_panel(sh, lp, q + 1, T, C, P, reverse);
      int t0, offset;
      panel_frames(q, T, P, reverse, t0, left);
      panel_source(lp, t0, C, offset);
      const int buf = q % kBuffers;
      hopper::mbar_wait(&sh.full[buf], (q / kBuffers) & 1);
      row = sh.panels + buf * panel_floats(P, C) + offset + (reverse ? (left - 1) * C : 0);
    }
    const float* r = row;
    row += reverse ? -C : C;
    --left;
    return r;
  }
};

// --- per-thread states ----------------------------------------------------------------
// Thread i's K states s = i K + k with what the recursion needs of each in
// registers.
template <int K>
struct States {
  int cls[K];          // class index, clamped into [0, C): a label outside
                       // it cannot read outside its logp row (the wrapper's
                       // contract is z in [0, C))
  unsigned valid = 0;  // bit k: state k lies inside its label
  unsigned step = 0;   // bit k: the state one step along (s - 1 for alpha,
                       // s + 1 for beta) exists
  unsigned skip = 0;   // bit k: the skip transition is allowed
  unsigned edge = 0;   // bit k: a valid start (alpha) or final (beta) state

  // dir: -1 for alpha (it reads s-1, s-2), +1 for beta (s+1, s+2). Alpha
  // allows the skip into s iff s >= 2 and noskip[s] is false; beta allows
  // the skip out of s iff s + 2 < S and noskip[s + 2] is false.
  __device__ __forceinline__ void load(const int* zb, const bool* noskip_b,
                                       const bool* valid_b, const bool* edge_b, int s0,
                                       int dir, int S, int C) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = s0 + k;
      cls[k] = 0;
      if (s >= S) continue;
      cls[k] = min(max(zb[s], 0), C - 1);
      const int sk = dir > 0 ? s + 2 : s;
      if (s + dir >= 0 && s + dir < S) step |= 1u << k;
      if (valid_b[s]) valid |= 1u << k;
      if (sk >= 2 && sk < S && !noskip_b[sk]) skip |= 1u << k;
      if (edge_b[s] && valid_b[s]) edge |= 1u << k;
    }
  }
};

// --- launching ---------------------------------------------------------------------
// Threads, dynamic shared memory and the kernel variant (log2 of the states
// a thread, or -1 for the strided path) of a launch; 0 threads if the
// kernels do not take the geometry.
struct Launch {
  int threads = 0;
  size_t smem = 0;
  int variant = 0;
};

constexpr size_t kSmemLimit = 232448;  // what a block may use on an H100

inline Launch launch_shape(int T, int C, int S, int panel, int per_thread) {
  Launch l;
  if (T < 1 || C < 1 || S < 1) return l;
  if (per_thread == 0) {  // the strided path: a warp multiple, at most 1024
    l.threads = min(kStridedThreads, (S + 31) / 32 * 32);
    l.variant = -1;
    return l;
  }
  if (panel < 1 || panel > T || per_thread < 1 ||
      per_thread > kMaxPerThread || (per_thread & (per_thread - 1)))
    return l;
  const int warps = ((S + per_thread - 1) / per_thread + 31) / 32;
  const size_t smem = fixed_bytes(warps) + kBuffers * size_t(panel_floats(panel, C)) * 4;
  if (warps > kMaxWarps || smem > kSmemLimit) return l;
  l.threads = 32 * warps;
  l.smem = smem;
  while ((1 << l.variant) < per_thread) ++l.variant;
  return l;
}

// Launch one variant on `stream` (one block a sample) and return
// cudaGetLastError(): a refused launch never runs.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), int B, const Launch& l, void* stream,
           Args... args) {
  if (l.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(l.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B, l.threads, l.smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ctc
