// K3: RWKV-6 chunked scan for Hopper (sm_90a), forward.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/rwkv6/rwkv6_scan.py::_rwkv_kernel.  Per (batch, head),
// from a zero state, with the log-decay lw <= 0 and the bonus u:
//
//     S_t = diag(exp(lw_t)) S_{t-1} + k_t^T v_t
//     y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//
// computed tile by tile.  With cum the inclusive prefix sum of lw inside a
// tile and S the state at the tile's start:
//
//     A[t][j] = sum_d r[t,d] k[j,d] exp(cum[t-1,d] - cum[j,d])   (j < t)
//     A[t][t] = sum_d r[t,d] u[d] k[t,d]
//     y[t]    = sum_j A[t][j] v[j] + (r[t] * exp(cum[t-1])) S
//     S'      = diag(exp(cum[C-1])) S + sum_j (k[j] * exp(cum[C-1] - cum[j]))^T v[j]
//
// The tile is the chunk when the chunk is at most 32 tokens, else the
// chunk's largest divisor up to 32 (the chunked form is exact for any
// chunk, so the result is the same function; the longest tile bounds the
// shared memory).  A tile is padded to a multiple of 16 rows with zero rows
// (r = k = v = lw = 0: no decay, no contribution).
//
// Design.  Each step attacks one cause that held the first K3 (one block
// per (b, h), 3.23-3.29 ms at the training shape on an NVIDIA H100 80GB
// HBM3 at 700.00 W, 17x its FMA-units bound):
// 1. Work split by dependence.  Only y += r'S and the state update carry
//    across tiles; the pairwise matrix A, r' and k' depend on the tile's
//    own r, k and lw.  So one iteration computes the state-free part of
//    tile c+1 and the products of tile c between two block-wide barriers,
//    three groups of warps take the state-free part at once (the diagonal
//    8-blocks; A's other blocks; r', k'), and A, r', k' and the decay are
//    kept for two tiles.  The value columns of S and y are independent
//    given A, so a block may take a slice of E value columns (a
//    launch-time constant by head dim, Cfg below; one slice measured
//    fastest).  A block has D/4 warps (16 at hd 64), twice the 8 warps per
//    SM of the first K3.
// 2. Pairwise decay factored across sub-chunks.  Inside a diagonal 8 x 8
//    block the exponent stays the difference cum[t-1] - cum[j] <= 0, on
//    the FMA units and the SFU.  Elsewhere the term splits at a block
//    boundary p (j <= p <= t-1) into 2^(c[t] - c[p+1]) 2^(c[p+1] - c[j+1]),
//    with c = log2(e) cum shifted one row (c[t] = cum[t-1]); both factors
//    are <= 1 because cum only falls.  The lower-left 8 x 8 quadrant of
//    each diagonal 16-block splits at its 8-block boundary, the
//    off-diagonal 16-block of a 32-row tile at row 16, so neither needs a
//    third, gap factor.  Those blocks are tensor-core products whose
//    decayed operands are formed as the fragments load, and only the 28
//    pairs of each diagonal 8-block need an exponential per channel: 7 K
//    per 32-token tile instead of 31.7 K.
//    The pairwise exponent is still never factored globally into
//    exp(cum[t-1]) * exp(-cum[j]): with lw down to -4, cum reaches -128
//    inside a chunk of 32 and exp(128) overflows fp32.
// 3. Tensor cores.  A's off-diagonal blocks, A.v, r'.S and k'^T.v run on
//    mma.sync: m16n8k16 bf16 with fp32 accumulators for bf16 inputs (the
//    operands r', k', A and the state are rounded to bf16, the sums are
//    fp32; the state itself stays fp32 in registers), and 3xTF32
//    (m16n8k8, each operand split into a TF32 head and tail, fp32
//    accumulation) for fp32 inputs, which are held to 1e-5.
// 4. Prefetch.  Tile c+2's r, k, v and lw are copied by cp.async (16-byte
//    copies) into the third of three stage buffers while the block works
//    on tiles c and c+1; the upper half of the block issues them, and
//    scans their lw once they land, behind its share of the products.  A
//    view whose hd stride is not 1, or whose rows are not 16-byte aligned,
//    takes plain loads instead, chosen once per launch.
// 5. Parallel prefix sums: every thread of the upper half scans a segment
//    of a channel and the segments of a channel combine by a shuffle scan.
// 6. What stays on the FMA units is tiled: a lane holds all 36 entries of
//    one diagonal 8-block for two channels and a reduce-scatter over the
//    block's lanes sums them.
//
// Bound (chip_smoke.py::rwkv6_work): at the training shape (B=2, S=4096,
// H=64, hd=64, chunk 32, bf16) 2.90 GFLOP on the FMA units at 67 TFLOP/s
// (0.043 ms) plus 9.70 GFLOP of products at the bf16 tensor rate of
// 989 TFLOP/s (0.010 ms), against 0.403 GB at 3.35 TB/s: 0.120 ms, set by
// the bytes.  (Counting all 12.6 GFLOP at the fp32 rate gave 0.188 ms.)
//
// Shared memory: three stage buffers (r, k, v and the prefix sums, whose
// rows 1..C receive lw), r', k', A (32 x 32) and the decay of two tiles,
// two copies of the state in the operand type; rows are padded by 16 bytes
// (8 for the buffers read transposed in fp32) so that fragment loads hit
// distinct banks.  kernels/rwkv6/rwkv6_scan.py::smem_bytes repeats the count.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int MAX_TILE = 32;       // tokens per tile, before padding to 16
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

// value columns (E) and warps (NW) of a block, by head dim
template <int D>
struct Cfg {
  static constexpr int E = D;
  static constexpr int NW = D / 4;
};

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* lw;
  const float* u;
  void* y;
  int B, S, H;
  int tile;        // tokens per tile: divides the chunk, at most MAX_TILE
  int vec;         // 1: rows staged by 16-byte cp.async (aligned, hd stride 1)
  // element strides (b, s, h, d) of r, k, v, lw, y, then (h, d) of u
  int64_t sr[4], sk[4], sv[4], slw[4], sy[4], su[2];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// c ? a : b on values already in registers (a select the compiler cannot
// turn into a load from a computed address, which would put the array it
// reads into local memory)
__device__ __forceinline__ float sel(bool c, float a, float b) {
  float y;
  asm("{\n .reg .pred q;\n setp.ne.b32 q, %1, 0;\n selp.f32 %0, %2, %3, q;\n}"
      : "=f"(y)
      : "r"((int)c), "f"(a), "f"(b));
  return y;
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// barrier `id` (1..15) over the first `n` threads to arrive (a multiple of 32)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Warp-level tensor-core products, one 16 x 8 output tile over a k step of
// 16.  Operands come from shared memory in one of four layouts: A stored
// [m][k] or [k][m], B stored [n][k] or [k][n] (pitch in elements).  The
// accumulator layout (PTX ISA, g = lane / 4, t = lane % 4): c[0], c[1] at
// row g, columns 2t, 2t+1; c[2], c[3] at row g+8.

template <typename T> struct Tc;

template <> struct Tc<bf16> {
  // m16n8k16: a[i] holds rows g (i even) or g+8 (i odd) at columns 2t, 2t+1
  // (+8 for i >= 2); b[i] holds k rows 2t, 2t+1 (+8 for i = 1) of column g
  struct A { uint32_t x[4]; };
  struct B { uint32_t x[2]; };

  static __device__ __forceinline__ void a_mk(A& a, const bf16* s, int pitch, int m0, int k0,
                                              int lane) {
    const bf16* p = s + (m0 + (lane & 15)) * pitch + k0 + (lane >> 4) * 8;
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(a.x[0]), "=r"(a.x[1]), "=r"(a.x[2]), "=r"(a.x[3])
                 : "r"(smem_u32(p)));
  }
  static __device__ __forceinline__ void a_km(A& a, const bf16* s, int pitch, int m0, int k0,
                                              int lane) {
    const int mat = lane >> 3;
    const bf16* p = s + (k0 + (lane & 7) + (mat >> 1) * 8) * pitch + m0 + (mat & 1) * 8;
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(a.x[0]), "=r"(a.x[1]), "=r"(a.x[2]), "=r"(a.x[3])
                 : "r"(smem_u32(p)));
  }
  // two 8-column B tiles (n0.. and n0+8..) by one ldmatrix.x4
  struct B2 { B lo, hi; };
  static __device__ __forceinline__ void b_nk2(B2& b, const bf16* s, int pitch, int n0, int k0,
                                               int lane) {
    const bf16* p = s + (n0 + (lane & 7) + (lane >> 4) * 8) * pitch + k0 + ((lane >> 3) & 1) * 8;
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(b.lo.x[0]), "=r"(b.lo.x[1]), "=r"(b.hi.x[0]), "=r"(b.hi.x[1])
                 : "r"(smem_u32(p)));
  }
  static __device__ __forceinline__ void b_kn2(B2& b, const bf16* s, int pitch, int n0, int k0,
                                               int lane) {
    const bf16* p = s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch + n0 + (lane >> 4) * 8;
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(b.lo.x[0]), "=r"(b.lo.x[1]), "=r"(b.hi.x[0]), "=r"(b.hi.x[1])
                 : "r"(smem_u32(p)));
  }
  static __device__ __forceinline__ void mma(float* c, const A& a, const B& b) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a.x[0]), "r"(a.x[1]), "r"(a.x[2]), "r"(a.x[3]), "r"(b.x[0]), "r"(b.x[1]));
  }
  // A from x [m][k] (rows m0.., columns k0..), each element times
  // 2^(c[m][k] - c[base][k]); rows m0..m0+7 zero if `top_zero`
  static __device__ __forceinline__ void a_decay(A& a, const bf16* x, int px, const float* c,
                                                 int pc, int m0, int k0, int base,
                                                 bool top_zero, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + g + (i & 1) * 8, k = k0 + 2 * t + (i >> 1) * 8;
      if (top_zero && !(i & 1)) {
        a.x[i] = 0u;
        continue;
      }
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + m * px + k));
      const float2 cm = *reinterpret_cast<const float2*>(c + m * pc + k);
      const float2 cb = *reinterpret_cast<const float2*>(c + base * pc + k);
      __nv_bfloat162 y = __floats2bfloat162_rn(v.x * ex2(cm.x - cb.x), v.y * ex2(cm.y - cb.y));
      a.x[i] = *reinterpret_cast<uint32_t*>(&y);
    }
  }
  // B from x [n][k] (rows n0.., columns k0..), each element times
  // 2^(c[base][k] - c[n+1][k])
  static __device__ __forceinline__ void b_decay(B& b, const bf16* x, int px, const float* c,
                                                 int pc, int n0, int k0, int base, int lane) {
    const int g = lane >> 2, t = lane & 3, n = n0 + g;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = k0 + 2 * t + i * 8;
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + n * px + k));
      const float2 cn = *reinterpret_cast<const float2*>(c + (n + 1) * pc + k);
      const float2 cb = *reinterpret_cast<const float2*>(c + base * pc + k);
      __nv_bfloat162 y = __floats2bfloat162_rn(v.x * ex2(cb.x - cn.x), v.y * ex2(cb.y - cn.y));
      b.x[i] = *reinterpret_cast<uint32_t*>(&y);
    }
  }
  // rows g and g+8 of an accumulator tile at columns 2t, 2t+1, as one word each
  static __device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

template <> struct Tc<float> {
  // 3xTF32: two m16n8k8 halves per k step of 16; a[hk][i] holds row g (i
  // even) or g+8 (i odd) at column t (+4 for i >= 2) of half hk; b[hk][i]
  // holds k row t (+4 for i = 1) of column g
  struct A { float x[2][4]; };
  struct B { float x[2][2]; };

  static __device__ __forceinline__ void a_mk(A& a, const float* s, int pitch, int m0, int k0,
                                              int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int hk = 0; hk < 2; ++hk) {
      const float* p = s + (m0 + g) * pitch + k0 + hk * 8 + t;
      a.x[hk][0] = p[0];
      a.x[hk][1] = p[8 * pitch];
      a.x[hk][2] = p[4];
      a.x[hk][3] = p[8 * pitch + 4];
    }
  }
  static __device__ __forceinline__ void a_km(A& a, const float* s, int pitch, int m0, int k0,
                                              int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int hk = 0; hk < 2; ++hk) {
      const float* p = s + (k0 + hk * 8 + t) * pitch + m0 + g;
      a.x[hk][0] = p[0];
      a.x[hk][1] = p[8];
      a.x[hk][2] = p[4 * pitch];
      a.x[hk][3] = p[4 * pitch + 8];
    }
  }
  static __device__ __forceinline__ void b_nk(B& b, const float* s, int pitch, int n0, int k0,
                                              int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int hk = 0; hk < 2; ++hk) {
      const float* p = s + (n0 + g) * pitch + k0 + hk * 8 + t;
      b.x[hk][0] = p[0];
      b.x[hk][1] = p[4];
    }
  }
  static __device__ __forceinline__ void b_kn(B& b, const float* s, int pitch, int n0, int k0,
                                              int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int hk = 0; hk < 2; ++hk) {
      const float* p = s + (k0 + hk * 8 + t) * pitch + n0 + g;
      b.x[hk][0] = p[0];
      b.x[hk][1] = p[4 * pitch];
    }
  }
  struct B2 { B lo, hi; };
  static __device__ __forceinline__ void b_nk2(B2& b, const float* s, int pitch, int n0, int k0,
                                               int lane) {
    b_nk(b.lo, s, pitch, n0, k0, lane);
    b_nk(b.hi, s, pitch, n0 + 8, k0, lane);
  }
  static __device__ __forceinline__ void b_kn2(B2& b, const float* s, int pitch, int n0, int k0,
                                               int lane) {
    b_kn(b.lo, s, pitch, n0, k0, lane);
    b_kn(b.hi, s, pitch, n0 + 8, k0, lane);
  }
  static __device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
  }
  static __device__ __forceinline__ void mma1(float* c, const uint32_t* a, const uint32_t* b) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ void mma(float* c, const A& a, const B& b) {
#pragma unroll
    for (int hk = 0; hk < 2; ++hk) {
      uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(a.x[hk][i], ah[i], al[i]);
#pragma unroll
      for (int i = 0; i < 2; ++i) split(b.x[hk][i], bh[i], bl[i]);
      mma1(c, al, bh);          // the small terms first
      mma1(c, ah, bl);
      mma1(c, ah, bh);
    }
  }
  static __device__ __forceinline__ void a_decay(A& a, const float* x, int px, const float* c,
                                                 int pc, int m0, int k0, int base,
                                                 bool top_zero, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int hk = 0; hk < 2; ++hk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + g + (i & 1) * 8, k = k0 + hk * 8 + t + (i >> 1) * 4;
        a.x[hk][i] = top_zero && !(i & 1) ? 0.f
                                          : x[m * px + k] * ex2(c[m * pc + k] - c[base * pc + k]);
      }
  }
  static __device__ __forceinline__ void b_decay(B& b, const float* x, int px, const float* c,
                                                 int pc, int n0, int k0, int base, int lane) {
    const int g = lane >> 2, t = lane & 3, n = n0 + g;
#pragma unroll
    for (int hk = 0; hk < 2; ++hk)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = k0 + hk * 8 + t + i * 4;
        b.x[hk][i] = x[n * px + k] * ex2(c[base * pc + k] - c[(n + 1) * pc + k]);
      }
  }
  static __device__ __forceinline__ void store_pair(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

// Sum acc over the aligned groups of 2*O lanes (O = half the group) and
// scatter: lane l of a group ends with entries [l N/(2O), (l+1) N/(2O)) of
// the sum in acc[0..].  Each step trades the half a lane gives up with its
// partner's copy of the half it keeps.  Recursive so that every index is a
// compile-time constant and acc stays in registers.
template <int O, int N>
__device__ __forceinline__ void reduce_scatter(float (&acc)[64], int lane) {
  if constexpr (O >= 1) {
    const bool hi = lane & O;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = sel(hi, acc[i], acc[i + N / 2]);
      const float keep = sel(hi, acc[i + N / 2], acc[i]);
      acc[i] = keep + __shfl_xor_sync(FULL, send, O);
    }
    reduce_scatter<O / 2, N / 2>(acc, lane);
  }
}

// ---------------------------------------------------------------------------
// Shared-memory layout of one block; pitches in elements

template <typename T, int D, int E>
struct Smem {
  static constexpr int PAD = 16 / (int)sizeof(T);     // 16 bytes
  static constexpr int PR = D + PAD;       // r, k stage; r' ([t][d])
  static constexpr int PK = D + 8;         // k' (read transposed)
  static constexpr int PV = E + 8;         // v stage (read as [k][n])
  static constexpr int PC = D + 4;         // prefix sums, fp32
  static constexpr int PA = MAX_TILE + PAD;
  static constexpr int PS = D + PAD;       // state copy, [e][d]
  static constexpr size_t R = (size_t)MAX_TILE * PR * sizeof(T);
  static constexpr size_t V = (size_t)MAX_TILE * PV * sizeof(T);
  static constexpr size_t CS = (size_t)(MAX_TILE + 1) * PC * 4;
  static constexpr size_t STAGE = 2 * R + V + CS;
  static constexpr size_t KP = (size_t)MAX_TILE * PK * sizeof(T);
  static constexpr size_t AM = (size_t)MAX_TILE * PA * sizeof(T);
  static constexpr size_t SO = (size_t)E * PS * sizeof(T);
  static constexpr size_t RP = 3 * STAGE, KPO = RP + 2 * R, AO = KPO + 2 * KP, SO0 = AO + 2 * AM;
  static constexpr size_t US = SO0 + 2 * SO, DEC = US + 4 * D;
  static constexpr size_t TOTAL = DEC + 8 * D;
  static_assert(R % 16 == 0 && V % 16 == 0 && CS % 16 == 0 && KP % 16 == 0 && AM % 16 == 0 &&
                    SO % 16 == 0,
                "16-byte aligned buffers");
};

template <typename T, int D, int E, int NW>
__global__ void __launch_bounds__(NW * 32, 1) rwkv6_fwd(Params p) {
  using L = Smem<T, D, E>;
  using MM = Tc<T>;
  constexpr int THREADS = NW * 32;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x / (D / E), e0 = (blockIdx.x % (D / E)) * E;
  const int b = bh / p.H, h = bh % p.H;
  const int CL = p.tile, CP = (CL + 15) & ~15, ntiles = p.S / CL;

  const T* rg = static_cast<const T*>(p.r) + b * p.sr[0] + h * p.sr[2];
  const T* kg = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[2];
  const T* vg = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[2] + e0 * p.sv[3];
  const float* lwg = p.lw + b * p.slw[0] + h * p.slw[2];
  T* yg = static_cast<T*>(p.y) + b * p.sy[0] + h * p.sy[2] + e0;

  auto rs = [&](int buf) { return reinterpret_cast<T*>(smem + buf * L::STAGE); };
  auto ks = [&](int buf) { return reinterpret_cast<T*>(smem + buf * L::STAGE + L::R); };
  auto vs = [&](int buf) { return reinterpret_cast<T*>(smem + buf * L::STAGE + 2 * L::R); };
  auto cs = [&](int buf) {
    return reinterpret_cast<float*>(smem + buf * L::STAGE + 2 * L::R + L::V);
  };
  auto rps = [&](int i) { return reinterpret_cast<T*>(smem + L::RP + i * L::R); };
  auto kps = [&](int i) { return reinterpret_cast<T*>(smem + L::KPO + i * L::KP); };
  auto Ams = [&](int i) { return reinterpret_cast<T*>(smem + L::AO + i * L::AM); };
  T* So0 = reinterpret_cast<T*>(smem + L::SO0);
  T* So1 = reinterpret_cast<T*>(smem + L::SO0 + L::SO);
  float* us = reinterpret_cast<float*>(smem + L::US);
  auto decs = [&](int i) { return reinterpret_cast<float*>(smem + L::DEC + i * 4 * D); };

  // 4. tile cc into stage buffer buf: rows 0..CL-1 of r, k, v and rows 1..CL
  //    of the prefix-sum buffer (lw); the padding rows stay zero from the
  //    start.  Aligned rows go by 16-byte cp.async copies, others by plain
  //    loads.  Threads t0 .. t0+nt-1 issue them.
  auto stage = [&](int cc, int buf, int t0, int nt) {
    const int64_t s0 = (int64_t)cc * CL;
    T *r_ = rs(buf), *k_ = ks(buf), *v_ = vs(buf);
    float* c_ = cs(buf);
    if (p.vec) {
      // row offsets in 32 bits: the launch takes this path only for row
      // strides below 2^26 elements
      constexpr int RE = 16 / (int)sizeof(T), RV = D / RE, VV = E / RE, LV = D / 4;
      const T *rt = rg + s0 * p.sr[1], *kt = kg + s0 * p.sk[1], *vt = vg + s0 * p.sv[1];
      const float* lt = lwg + s0 * p.slw[1];
      const int sr = (int)p.sr[1], sk = (int)p.sk[1], sv = (int)p.sv[1], sl = (int)p.slw[1];
      for (int i = tid - t0; i < CL * RV; i += nt) {
        const int t = i / RV, q = (i % RV) * RE;
        cp_async16(r_ + t * L::PR + q, rt + t * sr + q);
        cp_async16(k_ + t * L::PR + q, kt + t * sk + q);
      }
      for (int i = tid - t0; i < CL * VV; i += nt) {
        const int t = i / VV, q = (i % VV) * RE;
        cp_async16(v_ + t * L::PV + q, vt + t * sv + q);
      }
      for (int i = tid - t0; i < CL * LV; i += nt) {
        const int t = i / LV, q = (i % LV) * 4;
        cp_async16(c_ + (t + 1) * L::PC + q, lt + t * sl + q);
      }
      cp_async_commit();
    } else {
      for (int i = tid - t0; i < CL * D; i += nt) {
        const int t = i / D, d = i % D;
        r_[t * L::PR + d] = rg[(s0 + t) * p.sr[1] + d * p.sr[3]];
        k_[t * L::PR + d] = kg[(s0 + t) * p.sk[1] + d * p.sk[3]];
        c_[(t + 1) * L::PC + d] = lwg[(s0 + t) * p.slw[1] + d * p.slw[3]];
      }
      for (int i = tid - t0; i < CL * E; i += nt) {
        const int t = i / E, e = i % E;
        v_[t * L::PV + e] = vg[(s0 + t) * p.sv[1] + e * p.sv[3]];
      }
    }
  };

  // the state tiles this warp owns: S[d][e] for d in a 16-row block, e in
  // a 16-column block (two 8-column accumulator tiles), carried across
  // tiles in registers
  constexpr int NST = (D / 16) * (E / 16), NSW = (NST + NW - 1) / NW;
  float sacc[NSW][2][4] = {};

  // 5. prefix sums of a staged tile, by the upper half of the block:
  //    c2[t] = log2(e) * (lw[0] + ... + lw[t-1]), c2[0] = 0.  Thread
  //    (seg, d) scans rows of one segment; a shuffle scan over the NSEG
  //    lanes of a channel adds the segments before it.
  constexpr int HALF = THREADS / 2;
  auto scan = [&](float* c2) {
    constexpr int NSEG = HALF / D, ROWS = MAX_TILE / NSEG;
    static_assert(NSEG * D == HALF && NSEG <= 32 && 16 % NSEG == 0, "scan layout");
    const int u = tid - HALF, seg = u % NSEG, d = u / NSEG, rps = CP / NSEG;
    float run = 0.f, vals[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = seg * rps + i + 1;
      if (i < rps) run += (row <= CL ? c2[row * L::PC + d] : 0.f) * LOG2E;
      vals[i] = run;
    }
    float carry = run;
#pragma unroll
    for (int o = 1; o < NSEG; o <<= 1) {
      const float x = __shfl_up_sync(FULL, carry, o, NSEG);
      if (seg >= o) carry += x;
    }
    carry -= run;
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
      if (i < rps) c2[(seg * rps + i + 1) * L::PC + d] = vals[i] + carry;
  };

  // Iteration c computes the state-free part of tile c+1 and the products
  // of tile c, between one block-wide barrier and the next.  The upper half
  // of the block issues tile c+2's copies at the start and, after its share
  // of the work, waits for them and scans their lw.  Three stage buffers
  // (tiles c, c+1, c+2) and two of A, r', k' and the decay (tiles c, c+1)
  // keep the two parts apart.
  for (int i = tid; i < (int)(L::TOTAL / 16); i += THREADS)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if (tid >= HALF) {
    stage(0, 0, HALF, HALF);
    cp_async_wait_all();
    bar_sync(1, HALF);
    scan(cs(0));
  }
  for (int d = tid; d < D; d += THREADS) us[d] = p.u[h * p.su[0] + d * p.su[1]];

  const int n8 = CP / 8, n16 = CP / 16, nq = 3 * n16 - 2;
  for (int c = -1; c < ntiles; ++c) {
    __syncthreads();             // tile c+1 scanned; every warp is done with the last iteration
    if (c + 1 < ntiles) {
      // everything of tile c+1 that does not need the state, on three groups
      // of warps: in the lower half the diagonal 8-blocks of A and its other
      // blocks, in the upper half r' and k' (after tile c+2's copies)
      const int sb = (c + 1) % 3, ab = (c + 1) & 1;
      T *r_ = rs(sb), *k_ = ks(sb);
      float* c2 = cs(sb);
      T *Am = Ams(ab), *rp = rps(ab), *kp = kps(ab);
      float* dec = decs(ab);
      constexpr int P = D / 2, IPW = 32 / P;           // lanes per diagonal 8-block
      const int DW = (n8 + IPW - 1) / IPW;             // warps on the diagonal 8-blocks
      const int q0 = DW < NW / 2 ? DW : 0;             // then warps q0 .. q0+qn-1 on the rest
      const int qn = DW < NW / 2 ? NW / 2 - DW : DW;
      if (warp < DW) {
        // 2+6. the diagonal 8-blocks of A: lane `part` sums channels part and
        //      part + P of all 36 entries, then a reduce-scatter over the
        //      block's P lanes leaves 64 / P entries (row-major, the upper
        //      triangle zero) in each lane
        const int blk = warp * IPW + lane / P, part = lane % P;
        const bool live = blk < n8;
        float acc[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
        if (live) {
#pragma unroll 1
          for (int dd = 0; dd < 2; ++dd) {
            const int d = part + dd * P;
            float rv[8], kv[8], cv[9];
#pragma unroll
            for (int a = 0; a < 8; ++a) {
              rv[a] = to_f32(r_[(8 * blk + a) * L::PR + d]);
              kv[a] = to_f32(k_[(8 * blk + a) * L::PR + d]);
            }
#pragma unroll
            for (int a = 0; a < 9; ++a) cv[a] = c2[(8 * blk + a) * L::PC + d];
            const float ud = us[d];
#pragma unroll
            for (int a = 0; a < 8; ++a) {
#pragma unroll
              for (int j = 0; j < a; ++j) acc[a * 8 + j] += rv[a] * kv[j] * ex2(cv[a] - cv[j + 1]);
              acc[a * 9] += rv[a] * ud * kv[a];
            }
          }
        }
        reduce_scatter<P / 2, 64>(acc, part);
        if (live) {
          constexpr int MINE = 64 / P;
#pragma unroll
          for (int i = 0; i < MINE; ++i) {
            const int idx = part * MINE + i;
            Am[(8 * blk + idx / 8) * L::PA + 8 * blk + idx % 8] = from_f32<T>(acc[i]);
          }
        }
      }
      if (warp >= q0 && warp < q0 + qn) {
        // 2+3. the rest of A's lower triangle on tensor cores, split where no
        //      third factor is needed, the decayed operands formed as the
        //      fragments load.  Tile q < n16: the lower-left 8 x 8 quadrant
        //      of diagonal 16-block q, r of its rows 8..15 decayed to row
        //      16q+8 against k of its rows 0..7 decayed from there.  Then, for
        //      a 32-row tile, the off-diagonal 16-block in two 8-column tiles,
        //      split at row 16.
        for (int ti = warp - q0; ti < nq; ti += qn) {
          const bool quad = ti < n16;
          const int I16 = quad ? ti : 1, J8 = quad ? 2 * ti : ti - n16;
          const int split = quad ? 16 * ti + 8 : 16;
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
          for (int d16 = 0; d16 < D / 16; ++d16) {
            typename MM::A a;
            typename MM::B bb;
            MM::a_decay(a, r_, L::PR, c2, L::PC, 16 * I16, 16 * d16, split, quad, lane);
            MM::b_decay(bb, k_, L::PR, c2, L::PC, 8 * J8, 16 * d16, split, lane);
            MM::mma(acc, a, bb);
          }
          T* row = Am + (16 * I16 + g) * L::PA + 8 * J8 + 2 * tq;
          if (!quad) MM::store_pair(row, acc[0], acc[1]);
          MM::store_pair(row + 8 * L::PA, acc[2], acc[3]);
        }
      }
      if (tid >= HALF) {
        // 4. tile c+2's copies first; they land during this iteration
        if (c + 2 < ntiles) stage(c + 2, (c + 2) % 3, HALF, HALF);
        // 2. r' = r decayed to the tile's start (side 0) and k' = k decayed
        //    from the tile's end (side 1), one 8-block and channel per item;
        //    dec = 2^c2[CP], the tile's decay per channel
        for (int i = tid - HALF; i < n8 * D * 2; i += HALF) {
          const int d = i % D, side = (i / D) & 1, blk = i / (2 * D);
          if (side == 0) {
#pragma unroll 1
            for (int t = 8 * blk; t < 8 * blk + 8; ++t)
              rp[t * L::PR + d] = from_f32<T>(to_f32(r_[t * L::PR + d]) * ex2(c2[t * L::PC + d]));
          } else {
            const float end = c2[CP * L::PC + d];
#pragma unroll 1
            for (int j = 8 * blk; j < 8 * blk + 8; ++j)
              kp[j * L::PK + d] =
                  from_f32<T>(to_f32(k_[j * L::PR + d]) * ex2(end - c2[(j + 1) * L::PC + d]));
            if (blk == 0) dec[d] = ex2(end);
          }
        }
      }
    }
    if (c >= 0) {
      const int buf = c & 1;
      const T* v_ = vs(c % 3);
      const T *Am = Ams(buf), *rp = rps(buf), *kp = kps(buf);
      const float* dec = decs(buf);
      // 3. y = A v + r' S on tensor cores, S from the copy of the last tile.
      //    A warp takes 16 value columns (two 8-column tiles share each A
      //    fragment); A v and r' S go to two accumulators, two shorter chains
      //    of dependent products.
      const T* Sc = buf ? So1 : So0;
      T* Sn = buf ? So0 : So1;
      for (int yt = warp; yt < n16 * (E / 16); yt += NW) {
        const int I16 = yt / (E / 16), n0 = 16 * (yt % (E / 16));
        float acc[2][2][4] = {};
        typename MM::A a;
        typename MM::B2 bb;
        for (int j16 = 0; j16 <= I16; ++j16) {
          MM::a_mk(a, Am, L::PA, 16 * I16, 16 * j16, lane);
          MM::b_kn2(bb, v_, L::PV, n0, 16 * j16, lane);
          MM::mma(acc[0][0], a, bb.lo);
          MM::mma(acc[0][1], a, bb.hi);
        }
#pragma unroll 1
        for (int d16 = 0; d16 < D / 16; ++d16) {
          MM::a_mk(a, rp, L::PR, 16 * I16, 16 * d16, lane);
          MM::b_nk2(bb, Sc, L::PS, n0, 16 * d16, lane);
          MM::mma(acc[1][0], a, bb.lo);
          MM::mma(acc[1][1], a, bb.hi);
        }
        const int s0 = c * CL;
#pragma unroll
        for (int nh = 0; nh < 2; ++nh)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int t = 16 * I16 + g + 8 * hh, e = n0 + 8 * nh + 2 * tq;
            if (t < CL)
              MM::store_pair(yg + (int64_t)(s0 + t) * p.sy[1] + e,
                             acc[0][nh][2 * hh] + acc[1][nh][2 * hh],
                             acc[0][nh][2 * hh + 1] + acc[1][nh][2 * hh + 1]);
          }
      }

      // 3. S = diag(dec) S + k'^T v on tensor cores, 16 x 16 of S per task;
      //    the new state's copy in the operand type goes to the other buffer
#pragma unroll
      for (int i = 0; i < NSW; ++i) {
        const int st = warp + i * NW;
        if (st < NST) {
          const int d16 = st / (E / 16), n0 = 16 * (st % (E / 16));
          const float dg = dec[16 * d16 + g], dg8 = dec[16 * d16 + g + 8];
#pragma unroll
          for (int nh = 0; nh < 2; ++nh) {
            sacc[i][nh][0] *= dg;
            sacc[i][nh][1] *= dg;
            sacc[i][nh][2] *= dg8;
            sacc[i][nh][3] *= dg8;
          }
          typename MM::A a;
          typename MM::B2 bb;
          for (int j16 = 0; j16 < n16; ++j16) {
            MM::a_km(a, kp, L::PK, 16 * d16, 16 * j16, lane);
            MM::b_kn2(bb, v_, L::PV, n0, 16 * j16, lane);
            MM::mma(sacc[i][0], a, bb.lo);
            MM::mma(sacc[i][1], a, bb.hi);
          }
          const int d = 16 * d16 + g;
#pragma unroll
          for (int nh = 0; nh < 2; ++nh) {
            const int e = n0 + 8 * nh + 2 * tq;
            Sn[e * L::PS + d] = from_f32<T>(sacc[i][nh][0]);
            Sn[(e + 1) * L::PS + d] = from_f32<T>(sacc[i][nh][1]);
            Sn[e * L::PS + d + 8] = from_f32<T>(sacc[i][nh][2]);
            Sn[(e + 1) * L::PS + d + 8] = from_f32<T>(sacc[i][nh][3]);
          }
        }
      }
    }

    // 5. tile c+2's prefix sums, once its copies have landed
    if (tid >= HALF && c + 2 < ntiles) {
      cp_async_wait_all();
      bar_sync(1, HALF);
      scan(cs((c + 2) % 3));
    }
  }
}

bool aligned16(const void* ptr, const int64_t* s, int esize) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 || s[3] != 1 || s[1] >= (1 << 26) || s[1] < 0)
    return false;
  for (int i = 0; i < 3; ++i)
    if ((s[i] * esize) % 16) return false;
  return true;
}

template <typename T, int D>
cudaError_t launch(Params p, cudaStream_t stream) {
  constexpr int E = Cfg<D>::E, NW = Cfg<D>::NW;
  using L = Smem<T, D, E>;
  const int es = sizeof(T);
  p.vec = aligned16(p.r, p.sr, es) && aligned16(p.k, p.sk, es) && aligned16(p.v, p.sv, es) &&
          aligned16(p.lw, p.slw, 4);
  auto kernel = rwkv6_fwd<T, D, E, NW>;
  if (L::TOTAL > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::TOTAL);
    if (e != cudaSuccess) return e;
  }
  kernel<<<p.B * p.H * (D / E), NW * 32, L::TOTAL, stream>>>(p);
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
// (h, d), in elements; y's hd stride must be 1.  C is the chunk
// (S % C == 0, 1 <= C <= 128).
// Launches on `stream` without synchronising; returns cudaGetLastError()
// after the launch (0 = ok).
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v, const void* lw,
                              const void* u, void* y, int dtype, int B, int S, int H,
                              int D, int C, const int64_t* strides, void* stream) {
  if (C < 1 || C > 128 || S % C || strides[19] != 1) return (int)cudaErrorInvalidValue;
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
  p.tile = 1;
  for (int t = MAX_TILE < C ? MAX_TILE : C; t > 1; --t)
    if (C % t == 0) {
      p.tile = t;
      break;
    }
  p.vec = 0;
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
