// Flash attention forward for Hopper (sm_90a), GQA, causal or bidirectional.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::_flash_kernel
// (pl.pallas_call at :107), which computes softmax(Q K^T / sqrt(hd)) V with
// an online softmax (running max m, denominator l, fp32 accumulator) over kv
// blocks, skips kv blocks above the causal diagonal, masks padded keys and
// clamps l at 1e-30.
//
// What bounds it on an H100: at the whisper-large-v3 encoder shape (B=1,
// S=T=1500, H=K=20, hd=64, bf16, bidirectional) one call does 4*S*T*hd*H =
// 11.52 GFLOP against 15.36 MB of q/k/v/o traffic: 0.01165 ms at the 989
// TFLOP/s bf16 tensor-core peak against 0.0046 ms at 3.35 TB/s, so it is
// bound by operations.  Everything below serves to keep the tensor cores fed.
//
// bf16 at head dim 64, 128, 192: flash_fwd_hopper, warp-specialised.
//   One block of 3 warpgroups per (128-row q tile, q head, batch).  Warpgroup
//   2 is the producer: it drops to 24 registers (setmaxnreg) and one thread
//   issues TMA loads (cp.async.bulk.tensor) -- Q once, then K and V tiles
//   into two rings of 2-3 stages in shared memory, each slot guarded by a
//   "full" mbarrier (TMA's completed bytes) and an "empty" one (the
//   consumers' release), K running ahead of V.  Warpgroups 0 and 1 are the
//   consumers, 64 q rows each, raised to 240 registers: S = Q K^T by
//   wgmma.mma_async with both operands in shared memory (K-major), the online
//   softmax in registers on the SFU's exp2 with the scale folded in, P
//   rounded to bf16 in registers and fed as wgmma's register A operand of
//   O += P V, V read from shared memory as an MN-major B operand (the
//   transpose bit 16-bit types allow).  O stays in registers.  A consumer
//   issues S_i and P_{i-1} V_{i-1} together, runs the softmax of S_i while
//   the second product runs, and releases K_i and V_{i-1} as their products
//   retire; the two consumers take turns to issue (named barriers), so one's
//   softmax overlaps the other's products.
//   Every tile is a 64-column box of 128 bytes with TMA's 128-byte swizzle,
//   the layout wgmma's descriptors read; head dims 128 and 192 are 2 or 3
//   boxes.  TMA zero-fills the ragged S and T edges; only the tiles at the
//   T edge or across the causal diagonal are masked, and tiles above the
//   diagonal are never loaded.  Tensor maps are encoded on the host for
//   each call over the strided model layout; cuTensorMapEncodeTiled is
//   fetched with cudaGetDriverEntryPoint, so the library links no -lcuda.
//   What this does about the four limits of the mma.sync kernel it replaces
//   at these head dims: (1) K/V loads were synchronous copies through
//   registers with barriers around them -- TMA into the rings now runs ahead
//   of the products; (2) warp-level mma.sync cannot reach the tensor-core
//   rate -- wgmma can; (3) 128-168 registers a thread capped residency --
//   the producer gives its registers to the consumers; (4) each K/V tile
//   served 64 q rows -- it now serves 128, halving the L2 reads of K and V.
//   Tile shapes (rows of K/V per stage, stages): hd 64 -> 128 x 3, hd 128 ->
//   128 x 2, hd 192 -> 64 x 3.  128 q rows, not 192: the whisper shape then
//   has 12 x 20 = 240 blocks on 132 SMs (two waves of one block per SM)
//   where 192 rows give 160, and on the card three 64-row consumers ran the
//   whisper shape slower and a long causal hd-64 shape no faster.
//   What still holds it back, as read from timings (no stall counters can
//   be read on that card): at hd 64 the SFU's exp2 (16 a clock per SM) has
//   as much work per tile as the tensor cores, so even a perfect overlap
//   stops near half the bf16 peak; one block per SM leaves two consumer
//   warps per scheduler to hide latency; and each block pays its Q and
//   first K/V load before any product.
//
// bf16 at head dim 16 and 32 (reduced configs only): flash_fwd_bf16, the
// warp-level mma.sync m16n8k16 kernel, chosen by head dim in the launcher.
// A 16- or 32-column row is below TMA's 128-byte swizzle box.
//
// fp32 at every head dim: flash_fwd_f32, FMA products in fp32 throughout;
// lane l owns row l/2 of its warp and the even or odd columns.
//
// Layout: q (B,S,H,hd), k/v (B,T,K,hd), o (B,S,H,hd), addressed through
// element strides (no transposes, no padding in device memory).  Causal
// masking is bottom-right aligned: row i sees columns j <= i + (T - S), as
// in ref.py::attention_ref (S == T on the model path).

#include <cuda.h>            // CUtensorMap and its enums (no libcuda call is linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BLOCK_M = 64;      // q rows per block of the mma.sync and fp32 kernels
constexpr int BLOCK_N = 64;      // kv rows per tile of those kernels
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

// number of kv columns that q rows [m0, m0 + rows) must visit (the causal early exit)
__device__ __forceinline__ int kv_end(const Params& p, int m0, int rows) {
  if (!p.causal) return p.T;
  int last = m0 + rows - 1 + (p.T - p.S);      // last visible column of the rows
  return min(p.T, last + 1);
}

__device__ __forceinline__ bool visible(const Params& p, int row, int col) {
  return col < p.T && (!p.causal || col <= row + (p.T - p.S));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// bf16 at head dim 16 and 32: warp-level mma.sync m16n8k16, 64 q rows per
// block of 4 warps, K/V copied through registers into shared memory

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

  const int n_end = kv_end(p, m0, BLOCK_M);
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
// fp32, every head dim: FMA products

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

  const int n_end = kv_end(p, m0, BLOCK_M);
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

// ---------------------------------------------------------------------------
// bf16 at head dim 64, 128, 192: TMA, an mbarrier K/V ring, wgmma

namespace hopper {

constexpr int WG = 128;          // threads of a warpgroup
constexpr int BOX = 64;          // bf16 columns of one 128-byte swizzled TMA box
constexpr int CONSUMERS = 2;     // consumer warpgroups, 64 q rows each
constexpr int BM = 64 * CONSUMERS;
constexpr int THREADS = WG * (CONSUMERS + 1);
// one block a SM starts at 168 registers a thread (65536 / 384); the
// consumers grow into what the producer gives up: 128 * (168 - 24) =
// 256 * (240 - 168).  A larger request would never return.
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

template <int HD> struct Tile;                            // kv rows per stage, stages
template <> struct Tile<64> { static constexpr int BN = 128, STAGES = 3; };
template <> struct Tile<128> { static constexpr int BN = 128, STAGES = 2; };
template <> struct Tile<192> { static constexpr int BN = 64, STAGES = 3; };

// shared memory, from a 1024-byte aligned base (a swizzle atom is 8 rows of
// 128 bytes): Q as HD/64 boxes of BM rows; the K ring, then the V ring, each
// STAGES tiles of HD/64 boxes of BN rows; then 1 + 4 * STAGES mbarriers
template <int HD>
struct Smem {
  static constexpr int BN = Tile<HD>::BN, STAGES = Tile<HD>::STAGES, BOXES = HD / BOX;
  static constexpr uint32_t Q_BOX = BM * 128, KV_BOX = BN * 128;
  static constexpr uint32_t Q_BYTES = BOXES * Q_BOX;
  static constexpr uint32_t KV_BYTES = BOXES * KV_BOX;        // one K (or V) tile
  static constexpr uint32_t BARS = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr size_t bytes = BARS + 8 * (1 + 4 * STAGES) + 1024;   // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// one arrival that also announces the bytes TMA will complete on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map (hd, rows, heads, batch) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// wgmma shared-memory matrix descriptor (PTX ISA, "matrix descriptor"):
// start address, leading and stride byte offsets in 16-byte units, and
// layout 1 = 128-byte swizzle in bits 62-63
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of products are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of accumulator registers across
// the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, fp32) [+]= A (64 x 16) B (16 x N).  Accumulator layout: warp w
// of the warpgroup holds rows 16w..16w+15; d[4j..4j+1] are row g = lane/4,
// columns 8j + 2t, +1 (t = lane%4), and d[4j+2..4j+3] the same columns of
// row g + 8.  wgmma_ss: A and B from shared memory, both K-major.
// wgmma_rs_tb: A from registers (the mma.sync m16n8k16 A fragment of each
// warp's 16 rows), B MN-major ("transposed") from shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_tb(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_tb(float (&d)[96], const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95 "
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}


// 2^x on the SFU, denormal results flushed to 0: every argument here is <= 0
// (a score minus its row's running max), and what flushes is far below bf16
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// named barrier `id` among `threads` threads: wait for all, or only arrive
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// online softmax over one tile of scores, in place: sc becomes P = exp2(S *
// scale - m) in fp32, m and l move to the tile's new max, and alpha is the
// factor the accumulator must be scaled by.  Only a tile at the T edge or
// across the causal diagonal (`edge`) is masked.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&sc)[N], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const Params& p, int n0,
                                             int row0, int t, bool edge) {
  if (edge) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int col = n0 + (e / 4) * 8 + 2 * t + (e & 1);
      if (!visible(p, (e & 2) ? row0 + 8 : row0, col)) sc[e] = NEG_INF;
    }
  }
  float tmax[2] = {NEG_INF, NEG_INF}, mc[2];
#pragma unroll
  for (int e = 0; e < N; ++e) tmax[(e >> 1) & 1] = fmaxf(tmax[(e >> 1) & 1], sc[e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {                       // the 4 lanes of a row share its max
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    const float m_new = fmaxf(m[r], tmax[r]);
    alpha[r] = ex2((m[r] - m_new) * p.scale_log2);
    m[r] = m_new;
    mc[r] = m_new * p.scale_log2;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const int r = (e >> 1) & 1;
    float pe = ex2(fmaf(sc[e], p.scale_log2, -mc[r]));
    if (edge && !(sc[e] > NEG_INF)) pe = 0.f;         // a row with nothing visible has m = NEG_INF
    l[r] += pe;
    sc[e] = pe;
  }
}

// P rounded to bf16 into wgmma's register A fragments: n8 column groups 2kt
// and 2kt+1 of the scores are P's k-step kt
template <int N>
__device__ __forceinline__ void pack_p(const float (&sc)[N], uint32_t (&pf)[N / 8][4]) {
#pragma unroll
  for (int e = 0; e < N; e += 2) pf[e / 8][(e % 8) / 2] = pack_bf16(sc[e], sc[e + 1]);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_hopper(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, Params p) {
  using L = Smem<HD>;
  constexpr int BN = L::BN, STAGES = L::STAGES;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t q_smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_smem = q_smem + L::Q_BYTES;       // stage s at s * KV_BYTES
  const uint32_t v_smem = k_smem + STAGES * L::KV_BYTES;
  // mbarriers: q_full, then per stage k_full, v_full, k_empty, v_empty
  const uint32_t q_full = q_smem + L::BARS;
  auto k_full = [=](int s) { return q_full + 8 * (1 + 4 * s); };
  auto v_full = [=](int s) { return q_full + 8 * (2 + 4 * s); };
  auto k_empty = [=](int s) { return q_full + 8 * (3 + 4 * s); };
  auto v_empty = [=](int s) { return q_full + 8 * (4 + 4 * s); };

  const int h = blockIdx.x, b = blockIdx.z;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;  // the longest causal rows start first
  const int kvh = h / (p.H / p.K);
  const int n_tiles = (kv_end(p, m0, BM) + BN - 1) / BN;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), CONSUMERS * WG);
      mbar_init(v_empty(s), CONSUMERS * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: one thread keeps the rings full, K ahead of V
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS * WG) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int j = 0; j < L::BOXES; ++j)
        tma_load(q_smem + j * L::Q_BOX, &tq, q_full, j * BOX, m0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const uint32_t parity = ((i / STAGES) & 1) ^ 1;     // the first round passes at once
        mbar_wait(k_empty(s), parity);
        mbar_expect_tx(k_full(s), L::KV_BYTES);
        for (int j = 0; j < L::BOXES; ++j)
          tma_load(k_smem + s * L::KV_BYTES + j * L::KV_BOX, &tk, k_full(s), j * BOX, i * BN,
                   kvh, b);
        mbar_wait(v_empty(s), parity);
        mbar_expect_tx(v_full(s), L::KV_BYTES);
        for (int j = 0; j < L::BOXES; ++j)
          tma_load(v_smem + s * L::KV_BYTES + j * L::KV_BOX, &tv, v_full(s), j * BOX, i * BN,
                   kvh, b);
      }
    }
  } else {
    // consumers: 64 q rows each.  Tile i's scores are computed while tile
    // i-1's P V runs: S_i = Q K_i^T and O += P_{i-1} V_{i-1} are issued
    // together, the softmax of S_i overlaps the second, and O is rescaled
    // once that product has retired.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int tid = threadIdx.x % WG, lane = tid % 32, t = lane & 3;
    const int wg_row0 = m0 + wg * 64;
    const int row0 = wg_row0 + (tid / 32) * 16 + (lane >> 2);   // and row0 + 8: this thread's rows
    // tiles holding a column that one of these rows can see
    const int n_wg = min(n_tiles, (kv_end(p, wg_row0, 64) + BN - 1) / BN);
    const uint32_t qa = q_smem + wg * 64 * 128;       // these rows of each Q box
    auto edge = [&](int n0) {
      return n0 + BN > p.T || (p.causal && n0 + BN - 1 > wg_row0 + (p.T - p.S));
    };
    // S = Q K^T over HD/16 k-steps of 32 bytes inside the 128-byte rows
    auto issue_qk = [&](float (&sc)[BN / 2], int s) {
      const uint32_t ks = k_smem + s * L::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(sc, sw128_desc(qa + (kk / 4) * L::Q_BOX + (kk % 4) * 32, 16, 1024),
                 sw128_desc(ks + (kk / 4) * L::KV_BOX + (kk % 4) * 32, 16, 1024), kk > 0);
      wgmma_commit();
    };
    // O += P V, V as an MN-major operand: k-step kt is kv rows 16kt..16kt+15
    // (two swizzle atoms down), the HD/64 boxes LBO apart
    auto issue_pv = [&](float (&o)[HD / 2], const uint32_t (&pf)[BN / 16][4], int s) {
      const uint32_t vs = v_smem + s * L::KV_BYTES;
#pragma unroll
      for (int kt = 0; kt < BN / 16; ++kt)
        wgmma_rs_tb(o, pf[kt], sw128_desc(vs + kt * 16 * 128, L::KV_BOX, 1024), 1);
      wgmma_commit();
    };

    float o[HD / 2], sc[BN / 2], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
    uint32_t pf[BN / 16][4];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

    // the consumers take turns to issue their products (named barrier 1 + wg,
    // which this consumer and the one before it reach), so one's softmax runs
    // while another's products occupy the tensor cores.  Each takes n_tiles +
    // 1 turns; the first starts.
    auto take_turn = [&] { bar_sync(1 + wg, 2 * WG); };
    auto pass_turn = [&](bool last) {
      if (!last || wg + 1 < CONSUMERS) bar_arrive(1 + (wg + 1) % CONSUMERS, 2 * WG);
    };
    if (wg == 0) bar_arrive(1, 2 * WG);

    mbar_wait(q_full, 0);
    mbar_wait(k_full(0), 0);
    take_turn();
    wgmma_fence();
    issue_qk(sc, 0);
    pass_turn(false);
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(k_empty(0));
    softmax_tile(sc, m, l, alpha, p, 0, row0, t, edge(0));
    pack_p(sc, pf);
    for (int i = 1; i < n_wg; ++i) {
      const int s = i % STAGES, prev = (i - 1) % STAGES;
      mbar_wait(k_full(s), (i / STAGES) & 1);
      mbar_wait(v_full(prev), ((i - 1) / STAGES) & 1);
      take_turn();
      fence_regs(o);
      wgmma_fence();
      issue_qk(sc, s);
      issue_pv(o, pf, prev);
      pass_turn(false);
      wgmma_wait<1>();                                // S_i is in, P_{i-1} V_{i-1} may run on
      fence_regs(sc);
      mbar_arrive(k_empty(s));
      softmax_tile(sc, m, l, alpha, p, i * BN, row0, t, edge(i * BN));
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(v_empty(prev));
#pragma unroll
      for (int j = 0; j < HD / 2; j += 4) {
        o[j] *= alpha[0];
        o[j + 1] *= alpha[0];
        o[j + 2] *= alpha[1];
        o[j + 3] *= alpha[1];
      }
      pack_p(sc, pf);
    }
    const int last = (n_wg - 1) % STAGES;
    mbar_wait(v_full(last), ((n_wg - 1) / STAGES) & 1);
    take_turn();
    fence_regs(o);
    wgmma_fence();
    issue_pv(o, pf, last);
    pass_turn(n_wg == n_tiles);
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(v_empty(last));
    for (int i = n_wg; i < n_tiles; ++i) {            // tiles past these rows' diagonal
      const int s = i % STAGES;
      mbar_wait(k_full(s), (i / STAGES) & 1);
      mbar_arrive(k_empty(s));
      mbar_wait(v_full(s), (i / STAGES) & 1);
      mbar_arrive(v_empty(s));
      take_turn();
      pass_turn(i == n_tiles - 1);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row0 + 8 * r >= p.S) continue;
      bf16* orow = og + (int64_t)(row0 + 8 * r) * p.o_ss;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * l[r], o[4 * j + 2 * r + 1] * l[r]);
    }
  }
}

// cuTensorMapEncodeTiled, fetched from libcuda at run time
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// a (batch, rows, heads, hd) bf16 tensor with element strides, read in boxes
// of 64 columns x box_rows rows of one head; rows past the end read as zero
bool encode(CUtensorMap* map, const void* base, int B, int rows, int heads, int hd, int64_t s_b,
            int64_t s_row, int64_t s_head, int box_rows) {
  EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)rows, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s_row * 2, (cuuint64_t)s_head * 2,
                                 (cuuint64_t)s_b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)BOX, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// returned when cuTensorMapEncodeTiled refuses a tensor map (no CUDA error code says so)
constexpr int TENSOR_MAP_REFUSED = -1;

template <int HD>
int launch(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, p.q, p.B, p.S, p.H, HD, p.q_sb, p.q_ss, p.q_sh, BM) ||
      !encode(&tk, p.k, p.B, p.T, p.K, HD, p.k_sb, p.k_st, p.k_sh, Smem<HD>::BN) ||
      !encode(&tv, p.v, p.B, p.T, p.K, HD, p.v_sb, p.v_st, p.v_sh, Smem<HD>::BN))
    return TENSOR_MAP_REFUSED;
  auto kernel = flash_fwd_hopper<HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Smem<HD>::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(p.H, (p.S + BM - 1) / BM, p.B);
  kernel<<<grid, THREADS, Smem<HD>::bytes, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace hopper

template <typename Kernel>
int launch(Kernel kernel, size_t smem, const Params& p, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.S + BLOCK_M - 1) / BLOCK_M, p.H, p.B);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
int launch_f32(const Params& p, cudaStream_t stream) {
  return launch(flash_fwd_f32<HD>, F32Smem<HD>::bytes, p, stream);
}

template <int HD>
int launch_mma_sync(const Params& p, cudaStream_t stream) {
  return launch(flash_fwd_bf16<HD>, Bf16Smem<HD>::bytes, p, stream);
}

}  // namespace

// C entry, bound with ctypes.  Strides are in elements.  Launches on `stream`
// without synchronising; returns cudaGetLastError() after the launch (0 = ok),
// or -1 if cuTensorMapEncodeTiled refused a TMA tensor map for these strides.
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
    case 16: return is_bf16 ? launch_mma_sync<16>(p, st) : launch_f32<16>(p, st);
    case 32: return is_bf16 ? launch_mma_sync<32>(p, st) : launch_f32<32>(p, st);
    case 64: return is_bf16 ? hopper::launch<64>(p, st) : launch_f32<64>(p, st);
    case 128: return is_bf16 ? hopper::launch<128>(p, st) : launch_f32<128>(p, st);
    case 192: return is_bf16 ? hopper::launch<192>(p, st) : launch_f32<192>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of the kernel that flash_attention_fwd launches for
// this dtype and head dim, in bytes (0 for a head dim it refuses).
extern "C" int flash_attention_smem_bytes(int is_bf16, int hd) {
  switch (hd) {
    case 16: return is_bf16 ? Bf16Smem<16>::bytes : F32Smem<16>::bytes;
    case 32: return is_bf16 ? Bf16Smem<32>::bytes : F32Smem<32>::bytes;
    case 64: return is_bf16 ? hopper::Smem<64>::bytes : F32Smem<64>::bytes;
    case 128: return is_bf16 ? hopper::Smem<128>::bytes : F32Smem<128>::bytes;
    case 192: return is_bf16 ? hopper::Smem<192>::bytes : F32Smem<192>::bytes;
    default: return 0;
  }
}
