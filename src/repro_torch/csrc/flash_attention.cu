// Flash attention forward for Hopper (sm_90a), GQA, causal or bidirectional.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::_flash_kernel
// which computes softmax(Q K^T / sqrt(hd)) V with an online softmax (running
// max m, denominator l, fp32 accumulator) over kv blocks, skips kv blocks
// above the causal diagonal, masks padded keys and clamps l at 1e-30.
//
// What bounds it on an H100: at the whisper-large-v3 encoder shape
// (B=1, S=T=1500, H=K=20, hd=64, bf16, bidirectional) one call does
// 4*S*T*hd*H = 11.5 GFLOP of products against 15.4 MB of q/k/v/o traffic:
// 11.6 us at the 989 TFLOP/s bf16 tensor-core peak versus 4.6 us at
// 3.35 TB/s, so it is bound by operations.  The design therefore keeps every
// score and probability on chip, reads each K/V tile once per 64 query rows,
// and runs both products of the bf16 path on the tensor cores (warp-level
// mma.sync, fp32 accumulation) with S, P and the output accumulator held in
// registers.  The exponentials run on exp2 with the log2(e) factor folded
// into the score scale.  wgmma, TMA and a pipelined producer warp are later
// work; this version is the simple one that is right first.
//
// Layout and grid: q (B,S,H,hd), k/v (B,T,K,hd), o (B,S,H,hd), addressed
// through element strides (no transposes, no padding in device memory).
// One thread block of 4 warps per (64-row q tile, q head, batch); warp w owns
// q rows [16w, 16w+16) of the tile, so the softmax statistics of a row live
// in the lanes of one warp (a shuffle, never a block barrier); only the K/V
// tiles in shared memory are shared by the block.  A loop over 64-row kv
// tiles inside the block takes the place of the TPU's sequential kv grid
// axis and stops at the causal diagonal.  The ragged S and T edges are
// zero-filled on the way into shared memory and masked by column index.
// Causal masking is bottom-right aligned: row i sees columns j <= i + (T - S),
// as in ref.py::attention_ref (S == T on the model path).
//
// Two instantiations per head dim (16, 32, 64, 128):
//   bf16 inputs -> flash_fwd_bf16: mma.sync m16n8k16 products, S and the
//                  accumulator in mma fragments, P rounded to bf16 before P.V
//                  (as the model's plain path rounds probs to the compute
//                  dtype), fp32 m/l/acc.
//   fp32 inputs -> flash_fwd_f32: plain FMA products in fp32 throughout; lane
//                  l owns row l/2 of its warp and the even or odd columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BLOCK_M = 64;      // q rows per block
constexpr int BLOCK_N = 64;      // kv rows per tile
constexpr int THREADS = 128;     // 4 warps x 16 q rows
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, S, T, H, K;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int causal;
  float scale_log2;              // sm_scale * log2(e)
};

// number of kv columns block m0 must visit (the causal early exit)
__device__ __forceinline__ int kv_end(const Params& p, int m0) {
  if (!p.causal) return p.T;
  int last = m0 + BLOCK_M - 1 + (p.T - p.S);   // last visible column of the tile
  return min(p.T, last + 1);
}

__device__ __forceinline__ bool visible(const Params& p, int row, int col) {
  return col < p.T && (!p.causal || col <= row + (p.T - p.S));
}

// ---------------------------------------------------------------------------
// bf16: tensor-core products (mma.sync m16n8k16); S, P and O stay in registers

template <int HD>
struct Bf16Smem {
  static constexpr int LD = HD + 8;            // bf16 row pitch of the K/V tiles
  static constexpr size_t bytes = 2 * BLOCK_N * LD * sizeof(bf16);
};

// copy rows [r0, r0+64) of a (rows, HD) strided bf16 matrix into a padded tile,
// zero-filling rows >= nrows; 16-byte vectors
template <int HD>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src,
                                               int64_t row_stride, int r0,
                                               int nrows) {
  constexpr int VEC = 8;
  constexpr int PER_ROW = HD / VEC;
  for (int i = threadIdx.x; i < BLOCK_N * PER_ROW; i += THREADS) {
    int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * Bf16Smem<HD>::LD + c) = val;
  }
}

// c += a . b for one 16x8x16 tile.  Fragment layouts (PTX ISA, m16n8k16, g =
// lane / 4, t = lane % 4): a holds rows g, g+8 x cols 2t..2t+1, 2t+8..2t+9;
// b holds rows (k) 2t..2t+1 and 2t+8..2t+9 of column (n) g; c holds rows
// g, g+8 x cols 2t..2t+1.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two 8x8 b16 matrices whose rows lanes 0-15 address, transposed on the way:
// lane (g, t) receives M[2t][g], M[2t+1][g] of each
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const bf16* row) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

template <int HD>
__global__ void __launch_bounds__(THREADS) flash_fwd_bf16(Params p) {
  using L = Bf16Smem<HD>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BLOCK_N * L::LD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BLOCK_M, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.K);
  const int row0 = m0 + warp * 16 + g, row1 = row0 + 8;   // this lane's query rows

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;

  // Q as A fragments straight from device memory; rows >= S read as zero
  uint32_t qf[HD / 16][4];
  {
    const bool in0 = row0 < p.S, in1 = row1 < p.S;
    const bf16* q0 = qg + (int64_t)(in0 ? row0 : 0) * p.q_ss + 2 * t;
    const bf16* q1 = qg + (int64_t)(in1 ? row1 : 0) * p.q_ss + 2 * t;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qf[kk][0] = in0 ? *reinterpret_cast<const uint32_t*>(q0 + kk * 16) : 0u;
      qf[kk][1] = in1 ? *reinterpret_cast<const uint32_t*>(q1 + kk * 16) : 0u;
      qf[kk][2] = in0 ? *reinterpret_cast<const uint32_t*>(q0 + kk * 16 + 8) : 0u;
      qf[kk][3] = in1 ? *reinterpret_cast<const uint32_t*>(q1 + kk * 16 + 8) : 0u;
    }
  }

  // running max m and this lane's share of the denominator l, per row
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

  const int n_end = kv_end(p, m0);
  for (int n0 = 0; n0 < n_end; n0 += BLOCK_N) {
    __syncthreads();                                  // every warp is done with the last tile
    load_tile_bf16<HD>(Ks, kg, p.k_st, n0, p.T);
    load_tile_bf16<HD>(Vs, vg, p.v_st, n0, p.T);
    __syncthreads();

    // S = Q K^T: 8 column tiles of 8 kv rows; K rows are the B columns
    float s[BLOCK_N / 8][4];
#pragma unroll
    for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* krow = Ks + (nt * 8 + g) * L::LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma_bf16(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(krow + kk * 16),
                 *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8));
    }

    // scale and mask; element e of a tile is row (e < 2 ? row0 : row1)
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < BLOCK_N / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + nt * 8 + 2 * t + (e & 1);
        s[nt][e] = visible(p, e < 2 ? row0 : row1, col) ? s[nt][e] * p.scale_log2 : NEG_INF;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {                     // the 4 lanes of a row share its max
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m[i], tmax[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }

    // P = exp2(S - m), rounded to bf16 straight into A fragments: column
    // tiles 2j and 2j+1 of S are the two k halves of P's k tile j
    uint32_t pf[BLOCK_N / 16][4];
#pragma unroll
    for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pv[e] = s[nt][e] > NEG_INF ? exp2f(s[nt][e] - m[e >> 1]) : 0.f;   // masked -> 0
        l[e >> 1] += pv[e];
      }
      pf[nt / 2][(nt & 1) * 2] = pack_bf16(pv[0], pv[1]);
      pf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
    }

    // O = O * alpha + P V; V's B fragments come transposed out of shared memory
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
#pragma unroll
      for (int kt = 0; kt < BLOCK_N / 16; ++kt) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, Vs + (kt * 16 + (lane & 15)) * L::LD + dt * 8);
        mma_bf16(o[dt], pf[kt], b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
  if (row0 < p.S) {
    bf16* orow = og + (int64_t)row0 * p.o_ss + 2 * t;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
          __floats2bfloat162_rn(o[dt][0] / l[0], o[dt][1] / l[0]);
  }
  if (row1 < p.S) {
    bf16* orow = og + (int64_t)row1 * p.o_ss + 2 * t;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
          __floats2bfloat162_rn(o[dt][2] / l[1], o[dt][3] / l[1]);
  }
}

// ---------------------------------------------------------------------------
// fp32: FMA products

template <int HD>
struct F32Smem {
  static constexpr int LD = HD + 1;            // odd pitch: conflict-free column reads
  static constexpr int LDP = BLOCK_N + 1;
  static constexpr size_t bytes = (3 * BLOCK_M * LD + BLOCK_M * LDP) * sizeof(float);
};

template <int HD>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int64_t row_stride, int r0, int nrows) {
  for (int i = threadIdx.x; i < BLOCK_M * HD; i += THREADS) {
    int r = i / HD, c = i % HD;
    dst[r * F32Smem<HD>::LD + c] =
        r0 + r < nrows ? src[(int64_t)(r0 + r) * row_stride + c] : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS) flash_fwd_f32(Params p) {
  using L = F32Smem<HD>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + BLOCK_M * L::LD;
  float* Vs = Ks + BLOCK_N * L::LD;
  float* Ps = Vs + BLOCK_N * L::LD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = warp * 16 + (lane >> 1), odd = lane & 1;   // row in the tile, column parity
  const int m0 = blockIdx.x * BLOCK_M, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.K);
  const int row = m0 + r;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  load_tile_f32<HD>(Qs, qg, p.q_ss, m0, p.S);

  float m = NEG_INF, l = 0.f;
  float acc[HD / 2];
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) acc[j] = 0.f;

  const int n_end = kv_end(p, m0);
  for (int n0 = 0; n0 < n_end; n0 += BLOCK_N) {
    __syncthreads();
    load_tile_f32<HD>(Ks, kg, p.k_st, n0, p.T);
    load_tile_f32<HD>(Vs, vg, p.v_st, n0, p.T);
    __syncthreads();

    float s[BLOCK_N / 2];
#pragma unroll
    for (int j = 0; j < BLOCK_N / 2; ++j) s[j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float qd = Qs[r * L::LD + d];
#pragma unroll
      for (int j = 0; j < BLOCK_N / 2; ++j) s[j] = fmaf(qd, Ks[(2 * j + odd) * L::LD + d], s[j]);
    }
    float tmax = NEG_INF;
#pragma unroll
    for (int j = 0; j < BLOCK_N / 2; ++j) {
      s[j] = visible(p, row, n0 + 2 * j + odd) ? s[j] * p.scale_log2 : NEG_INF;
      tmax = fmaxf(tmax, s[j]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float alpha = exp2f(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BLOCK_N / 2; ++j) {
      int c = 2 * j + odd;
      float pj = visible(p, row, n0 + c) ? exp2f(s[j] - m_new) : 0.f;
      sum += pj;
      Ps[r * L::LDP + c] = pj;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = m_new;
    __syncwarp();                                     // both halves of the row are in Ps
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) acc[j] *= alpha;
    for (int n = 0; n < BLOCK_N; ++n) {
      const float pn = Ps[r * L::LDP + n];
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) acc[j] = fmaf(pn, Vs[n * L::LD + 2 * j + odd], acc[j]);
    }
  }

  if (row < p.S) {
    const float lc = fmaxf(l, 1e-30f);
    float* orow = og + (int64_t)row * p.o_ss;
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) orow[2 * j + odd] = acc[j] / lc;
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, const Params& p, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.S + BLOCK_M - 1) / BLOCK_M, p.H, p.B);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch(int is_bf16, const Params& p, cudaStream_t stream) {
  if (is_bf16) return launch(flash_fwd_bf16<HD>, Bf16Smem<HD>::bytes, p, stream);
  return launch(flash_fwd_f32<HD>, F32Smem<HD>::bytes, p, stream);
}

}  // namespace

// C entry, bound with ctypes.  Strides are in elements.  Launches on `stream`
// without synchronising; returns cudaGetLastError() after the launch (0 = ok).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int is_bf16, int B, int S, int T, int H, int K, int hd,
                                   int64_t q_sb, int64_t q_ss, int64_t q_sh,
                                   int64_t k_sb, int64_t k_st, int64_t k_sh,
                                   int64_t v_sb, int64_t v_st, int64_t v_sh,
                                   int64_t o_sb, int64_t o_ss, int64_t o_sh,
                                   int causal, float sm_scale, void* stream) {
  Params p{q, k, v, o, B, S, T, H, K,
           q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_ss, o_sh,
           causal, sm_scale * LOG2E};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return dispatch<16>(is_bf16, p, st);
    case 32: return dispatch<32>(is_bf16, p, st);
    case 64: return dispatch<64>(is_bf16, p, st);
    case 128: return dispatch<128>(is_bf16, p, st);
    default: return cudaErrorInvalidValue;
  }
}
