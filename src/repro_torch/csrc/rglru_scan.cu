// K2: RG-LRU linear recurrence for Hopper (sm_90a), forward.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/rglru/rglru_scan.py::_rglru_kernel.  Over (B, S, W),
// channel by channel, with h = 0 before the first step:
//
//     h_t = a_t * h_{t-1} + b_t
//
// The state is fp32; a and b are fp32 or bf16 (one type for both) and h
// takes their type.
//
// Design, against the TPU kernel:
// - The TPU grid (batch, 128-lane channel block, sequential time chunk)
//   carries the state from chunk to chunk in VMEM.  On Hopper one thread per
//   (b, channel) with a loop over time would give B*W threads (8192 at the
//   training shape, 64 blocks of 128 on 132 SMs), each with S dependent
//   steps: bound by latency.  Here the time axis is split too.
// - One block per (b, 32 channels), 32 x SEGS threads: threadIdx.x runs over
//   the channels, so each warp reads 128 contiguous bytes (fp32) per time
//   step of the model layout (B, S, W); threadIdx.y picks one of SEGS time
//   segments of L = ceil(S / SEGS) steps (the last one may be shorter or
//   empty).  At the training shape (B=2, S=4096, W=4096) that is 256 blocks
//   of 512 threads.
// - Pass 1: each thread scans its segment from a zero state and keeps the
//   segment's summary (prod a, h_end) in shared memory.
// - The 32 threads of segment 0 combine the SEGS summaries of their channel
//   in order, (A, H) o carry = A * carry + H, which leaves each segment's
//   carry-in in shared memory.
// - Pass 2: each thread rescans its segment from its carry-in and writes h.
//   A segment's product of a may underflow to 0 in pass 1; the carry's
//   share of h is then below fp32's range, so nothing is lost.
// - Loads of a and b do not depend on the state, so the unrolled time loop
//   keeps several in flight per thread.
//
// Bound: a memory-bound pass.  The function reads a and b once and writes h
// once (402.7 MB at the training shape in fp32: 0.120 ms at 3.35 TB/s; its
// 2 B*S*W FLOP are negligible).  This design reads a and b twice and writes
// h once, 1.67x the bound's bytes at best.  Vector loads, cp.async/TMA
// staging of the segment between the two passes, and a reverse-scan backward
// kernel are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 32;     // channels per block: one warp's lanes
constexpr int SEGS = 16;   // time segments per block

struct Params {
  const void* a;
  const void* b;
  void* h;
  int S, W, L;             // L: segment length, ceil(S / SEGS)
  // element strides (batch, time) of a, b, h; the channel stride is 1
  int64_t sa[2], sb[2], sh[2];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(CH * SEGS) rglru_fwd(Params p) {
  __shared__ float seg_a[SEGS][CH];   // pass 1: prod a over the segment
  __shared__ float seg_h[SEGS][CH];   // pass 1: h_end; then the carry-in

  const int lane = threadIdx.x, seg = threadIdx.y;
  const int w = blockIdx.x * CH + lane;
  const int64_t bi = blockIdx.y;
  const bool live = w < p.W;
  const int t0 = min(p.S, seg * p.L), t1 = min(p.S, t0 + p.L);
  const T* a = static_cast<const T*>(p.a) + bi * p.sa[0] + w;
  const T* b = static_cast<const T*>(p.b) + bi * p.sb[0] + w;
  T* h = static_cast<T*>(p.h) + bi * p.sh[0] + w;
  const int64_t ta = p.sa[1], tb = p.sb[1], th = p.sh[1];

  // pass 1: the segment's summary from a zero state
  float A = 1.f, H = 0.f;
  if (live) {
#pragma unroll 8
    for (int t = t0; t < t1; ++t) {
      const float at = to_f32(a[t * ta]);
      H = fmaf(at, H, to_f32(b[t * tb]));
      A *= at;
    }
  }
  seg_a[seg][lane] = A;
  seg_h[seg][lane] = H;
  __syncthreads();

  // carry-ins, in order of the segments
  if (seg == 0) {
    float carry = 0.f;
    for (int s = 0; s < SEGS; ++s) {
      const float next = fmaf(seg_a[s][lane], carry, seg_h[s][lane]);
      seg_h[s][lane] = carry;
      carry = next;
    }
  }
  __syncthreads();

  // pass 2: rescan from the carry-in and write h
  if (live) {
    float hv = seg_h[seg][lane];
#pragma unroll 8
    for (int t = t0; t < t1; ++t) {
      hv = fmaf(to_f32(a[t * ta]), hv, to_f32(b[t * tb]));
      store(h + t * th, hv);
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t st) {
  const dim3 grid((p.W + CH - 1) / CH, B), block(CH, SEGS);
  rglru_fwd<T><<<grid, block, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// a, b, h: (B, S, W) with the channel stride 1; strides holds the (batch,
// time) element strides of a, b and h.  dtype 0 = fp32, 1 = bf16.  Returns
// the launch's CUDA error code (0 on success).
extern "C" int rglru_scan_fwd(const void* a, const void* b, void* h, int dtype, int B,
                              int S, int W, const int64_t* strides, void* stream) {
  Params p;
  p.a = a;
  p.b = b;
  p.h = h;
  p.S = S;
  p.W = W;
  p.L = (S + SEGS - 1) / SEGS;
  int64_t* dst[3] = {p.sa, p.sb, p.sh};
  for (int t = 0; t < 3; ++t)
    for (int i = 0; i < 2; ++i) dst[t][i] = strides[2 * t + i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, B, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, B, st);
  return (int)cudaErrorInvalidValue;
}
