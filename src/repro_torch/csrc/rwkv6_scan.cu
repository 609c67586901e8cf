// K3: RWKV-6 chunked scan for Hopper (sm_90a), forward.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/rwkv6/rwkv6_scan.py::_rwkv_kernel.  Per (batch, head),
// with the log-decay lw <= 0 and the bonus u:
//
//     S_t = diag(exp(lw_t)) S_{t-1} + k_t^T v_t
//     y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//
// computed chunk by chunk (C tokens).  With cum the inclusive prefix sum of
// lw inside a chunk and S the state at the chunk's start:
//
//     A[t][j] = sum_d r[t,d] k[j,d] exp(cum[t-1,d] - cum[j,d])   (j < t)
//     A[t][t] = sum_d r[t,d] u[d] k[t,d]
//     y[t]    = sum_j A[t][j] v[j] + (r[t] * exp(cum[t-1])) S
//     S'      = diag(exp(cum[C-1])) S + sum_j (k[j] * exp(cum[C-1] - cum[j]))^T v[j]
//
// Design, against the TPU kernel:
// - One thread block per (b, h) and a loop over the chunks inside it: the
//   TPU's sequential chunk grid axis, whose VMEM scratch carried the state,
//   becomes a loop, and the hd x hd fp32 state stays in shared memory across
//   chunks, so the recurrence costs no device-memory traffic.
// - The Pallas kernel materializes the (C, C, hd) pairwise-decay block
//   (256 KiB at C = 32, hd = 64), more than a Hopper block's 227 KB of
//   shared memory.  Here each thread accumulates its A[t][j] over d, forming
//   each exp(cum[t-1,d] - cum[j,d]) as it goes: only the C x C matrix is kept.
// - The pairwise exponent is always formed as a difference (<= 0).  It is
//   never factored into exp(cum[t-1]) * exp(-cum[j]): with lw down to -4,
//   cum reaches -128 inside a chunk of 32 and exp(128) overflows fp32.
// - r, k, v, lw and y are read and written in the model layout (B, S, H, hd)
//   through strides, so the wrapper neither transposes nor copies.
// - All arithmetic is fp32 on the FMA units (the reference upcasts too; TF32
//   tensor cores would miss the 1e-5 fp32 limit).  r, k, v are fp32 or bf16;
//   lw and u are fp32; y takes r's type.
//
// Bound: at the training shape (B=2, S=4096, H=64, hd=64, C=32) the work is
// about 12.6 GFLOP of fp32 against about 0.40 GB of traffic, so the FMA rate
// bounds it (chip_smoke.py computes both).  With one block per (b, h) only
// B*H blocks run, one per SM; tensor cores for the C x hd x hd products,
// cp.async/TMA staging and more blocks per head are later work.
//
// Shared memory, fp32: r, k, v tiles and the (C+1)-row prefix sums with rows
// padded to hd+1 (column reads across a warp's lanes then hit distinct
// banks), A (C x C), the state (hd x hd), u and the chunk's total decay:
// 54.5 KB at C = 32, hd = 64, so the launch sets the dynamic shared-memory
// attribute above the 48 KB default.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* lw;
  const float* u;
  void* y;
  int B, S, H, C;
  // element strides (b, s, h, d) of r, k, v, lw, y, then (h, d) of u
  int64_t sr[4], sk[4], sv[4], slw[4], sy[4], su[2];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// kernels/rwkv6/rwkv6_scan.py::smem_bytes repeats this count
constexpr size_t smem_floats(int C, int D) {
  return 3 * (size_t)C * (D + 1) + (size_t)(C + 1) * (D + 1) + (size_t)C * C
         + (size_t)D * D + 2 * (size_t)D;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) rwkv6_fwd(Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int P = D + 1;          // padded row length
  const int C = p.C;
  float* rs = smem;                 // C x P: r, then r * exp(cum[t-1])
  float* ks = rs + C * P;           // C x P: k, then k * exp(cum[C-1] - cum[t])
  float* vs = ks + C * P;           // C x P: v
  float* cx = vs + C * P;           // (C+1) x P: cx[t] = cum[t-1], cx[0] = 0
  float* A = cx + (C + 1) * P;      // C x C
  float* St = A + C * C;            // D x D state, carried across chunks
  float* us = St + D * D;           // D: u[h]
  float* dec = us + D;              // D: exp(cum[C-1])

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int tid = threadIdx.x;
  const T* r = static_cast<const T*>(p.r) + b * p.sr[0] + h * p.sr[2];
  const T* k = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[2];
  const T* v = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[2];
  const float* lw = p.lw + b * p.slw[0] + h * p.slw[2];
  T* y = static_cast<T*>(p.y) + b * p.sy[0] + h * p.sy[2];

  for (int i = tid; i < D * D; i += THREADS) St[i] = 0.f;
  for (int d = tid; d < D; d += THREADS) {
    us[d] = p.u[h * p.su[0] + d * p.su[1]];
    cx[d] = 0.f;
  }

  for (int c0 = 0; c0 < p.S; c0 += C) {
    // 1. stage the chunk in fp32; lw goes into the prefix-sum rows 1..C
    for (int i = tid; i < C * D; i += THREADS) {
      const int t = i / D, d = i % D;
      const int64_t s = c0 + t;
      rs[t * P + d] = to_f32(r[s * p.sr[1] + d * p.sr[3]]);
      ks[t * P + d] = to_f32(k[s * p.sk[1] + d * p.sk[3]]);
      vs[t * P + d] = to_f32(v[s * p.sv[1] + d * p.sv[3]]);
      cx[(t + 1) * P + d] = lw[s * p.slw[1] + d * p.slw[3]];
    }
    __syncthreads();

    // 2. inclusive prefix sums down each column
    for (int d = tid; d < D; d += THREADS)
      for (int t = 1; t <= C; ++t) cx[t * P + d] += cx[(t - 1) * P + d];
    __syncthreads();

    // 3. the intra-chunk matrix, lower triangle and diagonal; a warp holds
    //    one row t and 32 columns j
    for (int i = tid; i < C * C; i += THREADS) {
      const int t = i / C, j = i % C;
      const float* rt = rs + t * P;
      float acc = 0.f;
      if (j < t) {
        const float* kj = ks + j * P;
        const float* ct = cx + t * P;          // cum[t-1]
        const float* cj = cx + (j + 1) * P;    // cum[j]
#pragma unroll 8
        for (int d = 0; d < D; ++d) acc += rt[d] * kj[d] * expf(ct[d] - cj[d]);
      } else if (j == t) {
        const float* kt = ks + t * P;
#pragma unroll 8
        for (int d = 0; d < D; ++d) acc += rt[d] * us[d] * kt[d];
      }
      A[i] = acc;
    }
    __syncthreads();

    // 4. fold the decays into r (to the chunk start) and k (to its end)
    for (int i = tid; i < C * D; i += THREADS) {
      const int t = i / D, d = i % D;
      rs[t * P + d] *= expf(cx[t * P + d]);
      ks[t * P + d] *= expf(cx[C * P + d] - cx[(t + 1) * P + d]);
    }
    for (int d = tid; d < D; d += THREADS) dec[d] = expf(cx[C * P + d]);
    __syncthreads();

    // 5. y = A v + (r * exp(cum[t-1])) S
    for (int i = tid; i < C * D; i += THREADS) {
      const int t = i / D, e = i % D;
      float acc = 0.f;
      for (int j = 0; j <= t; ++j) acc += A[t * C + j] * vs[j * P + e];
#pragma unroll 8
      for (int d = 0; d < D; ++d) acc += rs[t * P + d] * St[d * D + e];
      store(y + (c0 + t) * p.sy[1] + e * p.sy[3], acc);
    }
    __syncthreads();

    // 6. S = diag(exp(cum[C-1])) S + (k * exp(cum[C-1] - cum))^T v
    for (int i = tid; i < D * D; i += THREADS) {
      const int d = i / D, e = i % D;
      float acc = St[i] * dec[d];
      for (int j = 0; j < C; ++j) acc += ks[j * P + d] * vs[j * P + e];
      St[i] = acc;
    }
    __syncthreads();
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_floats(p.C, D) * sizeof(float);
  auto kernel = rwkv6_fwd<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<p.B * p.H, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// y = RWKV-6 scan of (r, k, v, lw, u); dtype 0 = fp32, 1 = bf16 for r, k, v
// and y.  strides: 4 each for r, k, v, lw, y (b, s, h, d), then 2 for u
// (h, d), in elements.  Launches on `stream` without synchronising; returns
// cudaGetLastError() after the launch (0 = ok).
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v, const void* lw,
                              const void* u, void* y, int dtype, int B, int S, int H,
                              int D, int C, const int64_t* strides, void* stream) {
  Params p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.lw = static_cast<const float*>(lw);
  p.u = static_cast<const float*>(u);
  p.y = y;
  p.B = B;
  p.S = S;
  p.H = H;
  p.C = C;
  int64_t* dst[5] = {p.sr, p.sk, p.sv, p.slw, p.sy};
  for (int t = 0; t < 5; ++t)
    for (int i = 0; i < 4; ++i) dst[t][i] = strides[4 * t + i];
  p.su[0] = strides[20];
  p.su[1] = strides[21];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(p, D, st);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(p, D, st);
  return (int)cudaErrorInvalidValue;
}
