// K2: RG-LRU linear recurrence for Hopper (sm_90a), forward.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/rglru/rglru_scan.py::_rglru_kernel (pl.pallas_call at
// :52).  Over (B, S, W), channel by channel, with h = 0 before the first step:
//
//     h_t = a_t * h_{t-1} + b_t
//
// The state is fp32; a and b are fp32 or bf16 (one type for both) and h
// takes their type.  bf16 is converted to fp32 as it is read, and only the
// stored h rounds.  Each step rounds as the TPU kernel's `a[t] * h + b[t]`
// and the port's decode step (models/rglru.py::rglru_decode) round it: the
// product, then the sum, never fused.  So h is bit-identical to the plain
// time loop (kernels/rglru/ref.py::rglru_sequential), and a prefill through
// K2 hands decode the state its own steps would have reached.
//
// Bound: bytes.  The function reads a and b once and writes h once (402.7 MB
// at recurrentgemma-9b's training shape B=2, S=4096, W=4096 in fp32: 0.120 ms
// at 3.35 TB/s; 0.031 ms for a 2112-token prefill at B=1).  Its 2 B*S*W FLOP
// are negligible.  So the design moves exactly those bytes and keeps enough
// of them in flight to run at the card's rate.
//
// Design, against the TPU kernel (which walks time chunks of 64 in order on
// one core and carries the state in VMEM from one grid step to the next):
// - One block per (b, slab of 128 bytes of channels): 32 fp32 or 64 bf16
//   channels, so one time step of a slab is one 128-byte row.  At W = 4096
//   that is 128 slabs per batch row.  The block walks time in chunks of TC
//   steps and carries the fp32 state from chunk to chunk in registers, as the
//   TPU kernel carries it in VMEM.  No segment summary, carry chain or second
//   pass: every byte of a and b is read from device memory once.
// - Warp 1, lane 0 is the producer: it issues TMA tile loads
//   (cp.async.bulk.tensor) of a and b, TC rows of the slab each, from rank-3
//   tensor maps over (W, S, B) with the caller's time and batch strides, into
//   a ring of STAGES chunks in shared memory.  Each stage has a "full"
//   mbarrier (TMA's completed bytes) and an "empty" one (the consumer's
//   release).  How far it runs ahead is set per launch from the grid: the
//   whole ring when there are no more blocks than SMs (a B=1 prefill: one
//   block per SM needs 2-3 chunks, 32-48 KB, in flight to cover the latency
//   at its share of the card's rate), one chunk when there are more (the
//   training shape: two or three blocks share each SM, and prefetching the
//   whole ring measured 7 % slower there, a cause no counter there shows).
// - Warp 0 is the consumer: lane l holds the state of the slab's channels
//   l (fp32) or 2l, 2l+1 (bf16), so each step is one conflict-free 4-byte
//   shared load of a and of b, one multiply and one add per channel, and one
//   4-byte shared store of h over b.  After a chunk, lane 0 hands the chunk's
//   h to a TMA store and releases the stage once the store has read it, one
//   chunk later.  The chain of 2 dependent operations per step is a small
//   share of a chunk's time at the card's rate.
// - TMA zero-fills channels past W and steps past S on load and clips them
//   on store, so a ragged W or S needs no mask: a = b = 0 there.
// - Views TMA cannot describe (a base that is not 16-byte aligned, or a
//   time or batch stride that is not a multiple of 16 bytes) take the
//   second path of the same kernel, chosen by the wrapper: the consumer warp
//   reads a and b from device memory with plain loads and writes h with
//   plain stores, one time step after another, masked at the W edge.  It is
//   latency-bound (a few loads in flight per lane) and no model path takes it.
//
// What still holds it back, as measured (PERF.md, K2's row): at the training
// and prefill shapes K2 runs within a few per cent of a plain elementwise
// pass over the same bytes (torch.add(a, b, out=h)), which itself reaches
// 89-92 % of 3.35 TB/s; taking the recurrence out (h = b) saves under 2 %.  So
// what is left is the card's practical streaming rate, each block's fill and
// drain of the ring, and at B=1 the 4 of 132 SMs that 128 slabs leave idle.
//
// LOOKBACK_CHUNKS > 0 builds the design that was not kept, for
// kernels/rglru/breakdown.py: time split across blocks in tiles of
// LOOKBACK_CHUNKS chunks with a single-pass chained scan (decoupled
// look-back, Merrill & Garland 2016).  Blocks take tiles in ticket order
// from an atomic counter (all tiles of one time position before the next),
// scan their tile from a zero state in shared memory, publish its
// aggregate (prod a, h_end), look back over their predecessors' aggregates
// and inclusive prefixes for their carry-in, publish their own inclusive
// prefix, then rescan the tile from the carry-in.  Its flags and aggregates
// live in a static buffer of the library, so that build serves one launch
// at a time.
#define LOOKBACK_CHUNKS 0

#include <cuda.h>            // CUtensorMap and its enums (no libcuda call is linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW = 128;                      // bytes of one time step of a slab
constexpr int WORDS = ROW / 4;                // 4-byte words per row: one per lane
constexpr int TC = 64;                        // time steps per chunk
constexpr int STAGES = 4;                     // chunks in the ring
constexpr int CHUNK_BYTES = TC * ROW;         // one array's chunk: 8 KB
constexpr int STAGE_BYTES = 2 * CHUNK_BYTES;  // a, then b (and h over b)
constexpr int THREADS = 64;                   // warp 0 consumes, warp 1 lane 0 loads
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 128;  // + alignment slack
static_assert(LOOKBACK_CHUNKS <= STAGES, "a look-back tile stays in the ring");

struct Params {
  const void* a;
  const void* b;
  void* h;
  int B, S, W;
  int depth;               // chunks in flight at most, 1..STAGES (TMA path)
  // element strides (batch, time) of a, b, h; the channel stride is 1
  int64_t sa[2], sb[2], sh[2];
};

// one lane's 4-byte word of a row: 1 fp32 channel or 2 bf16 channels
template <typename T>
struct Word;

template <>
struct Word<float> {
  static constexpr int N = 1;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  __device__ static void load(const uint32_t* p, float (&x)[N]) { x[0] = __uint_as_float(*p); }
  __device__ static void store(uint32_t* p, const float (&x)[N]) { *p = __float_as_uint(x[0]); }
};

template <>
struct Word<__nv_bfloat16> {
  static constexpr int N = 2;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ static void load(const uint32_t* p, float (&x)[N]) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    x[0] = f.x;
    x[1] = f.y;
  }
  __device__ static void store(uint32_t* p, const float (&x)[N]) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x[0], x[1]);
  }
};

// one step, rounded as the TPU kernel's `a[t] * h + b[t]` and the port's
// decode step round it: the product, then the sum (never an FMA)
__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

// one box of a rank-3 tensor map (channel, step, batch) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c, int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(t), "r"(b)
      : "memory");
}

// one box from shared memory out to a rank-3 tensor map; clipped at its edges
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c, int t,
                                          int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c), "r"(t), "r"(b)
      : "memory");
}

// this thread's shared-memory writes, ordered before its later TMA stores
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// all but the newest N committed stores have read their shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// TC steps of one chunk in shared memory: a and bh point at this lane's word
// of the chunk's first row; h over b, in place.  A prod-a aggregate is kept
// only when asked (the look-back's first pass, which writes nothing).
template <typename T, bool AGGREGATE>
__device__ __forceinline__ void scan_chunk(const uint32_t* a, uint32_t* bh,
                                           float (&h)[Word<T>::N], float (&prod)[Word<T>::N]) {
  constexpr int N = Word<T>::N, U = 8;
#pragma unroll 1
  for (int t0 = 0; t0 < TC; t0 += U) {
    float av[U][N], bv[U][N];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      Word<T>::load(a + (t0 + u) * WORDS, av[u]);
      Word<T>::load(bh + (t0 + u) * WORDS, bv[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        h[e] = step(av[u][e], h[e], bv[u][e]);
        if (AGGREGATE) prod[e] *= av[u][e];
        bv[u][e] = h[e];
      }
      if (!AGGREGATE) Word<T>::store(bh + (t0 + u) * WORDS, bv[u]);
    }
  }
}

#if LOOKBACK_CHUNKS
constexpr int MAX_TILES = 8192;
__device__ int g_ticket;
__device__ int g_status[MAX_TILES];            // 0: nothing, 1: aggregate, 2: inclusive
__device__ float g_prod[MAX_TILES][2 * WORDS];  // prod a over the tile, per channel
__device__ float g_agg[MAX_TILES][2 * WORDS];   // h_end of the tile from a zero state
__device__ float g_incl[MAX_TILES][2 * WORDS];  // h_end of the tile from its carry-in

// the carry into `tile` (time position j > 0) from its predecessors, which
// sit `stride` tickets apart; lane 0 spins on their flags
template <int N>
__device__ void look_back(int tile, int stride, int lane, float (&carry)[N]) {
  float acc_a[N], acc_h[N];
  for (int e = 0; e < N; ++e) acc_a[e] = 1.f, acc_h[e] = 0.f;
  for (int k = tile - stride; k >= 0; k -= stride) {
    int status = 0;
    if (lane == 0) {
      while ((status = *reinterpret_cast<volatile int*>(&g_status[k])) == 0) {
      }
      __threadfence();
    }
    status = __shfl_sync(0xffffffffu, status, 0);
    for (int e = 0; e < N; ++e) {
      const int i = N * lane + e;
      if (status == 2) {
        carry[e] = step(acc_a[e], __ldcg(&g_incl[k][i]), acc_h[e]);
      } else {
        acc_h[e] = step(acc_a[e], __ldcg(&g_agg[k][i]), acc_h[e]);
        acc_a[e] *= __ldcg(&g_prod[k][i]);
      }
    }
    if (status == 2) return;
  }
}
#endif

template <typename T, bool TMA>
__global__ void __launch_bounds__(THREADS)
    rglru_fwd(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
              const __grid_constant__ CUtensorMap mh, const Params p) {
  constexpr int N = Word<T>::N, CH = ROW / sizeof(T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nchunks = (p.S + TC - 1) / TC;

  if constexpr (!TMA) {
    // plain loads and stores, one time step after another
    if (warp != 0) return;
    const int64_t bi = blockIdx.y;
    const T* a = static_cast<const T*>(p.a) + bi * p.sa[0];
    const T* b = static_cast<const T*>(p.b) + bi * p.sb[0];
    T* h = static_cast<T*>(p.h) + bi * p.sh[0];
    int w[N];
    bool live[N];
    float hv[N];
    for (int e = 0; e < N; ++e) {
      w[e] = blockIdx.x * CH + N * lane + e;
      live[e] = w[e] < p.W;
      hv[e] = 0.f;
    }
#pragma unroll 4
    for (int64_t t = 0; t < p.S; ++t) {
      for (int e = 0; e < N; ++e) {
        if (!live[e]) continue;
        hv[e] = step(to_f32(a[t * p.sa[1] + w[e]]), hv[e], to_f32(b[t * p.sb[1] + w[e]]));
        store(h + t * p.sh[1] + w[e], hv[e]);
      }
    }
    return;
  } else {
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);  // TMA: 128-aligned
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
    auto full = [&](int s) { return smem_u32(bars + s); };
    auto empty = [&](int s) { return smem_u32(bars + STAGES + s); };
    auto stage_a = [&](int s) { return smem + s * STAGE_BYTES; };

#if LOOKBACK_CHUNKS
    __shared__ int ticket;
    if (threadIdx.x == 0) ticket = atomicAdd(&g_ticket, 1);
#endif
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(full(s), 1);
        mbar_init(empty(s), 1);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

#if LOOKBACK_CHUNKS
    // tickets run over the (b, slab) rows of one time position, then the next
    const int my_tile = ticket, rows = gridDim.x * p.B;
    const int j = my_tile / rows, slab = my_tile % rows % gridDim.x;
    const int bi = my_tile % rows / gridDim.x;
    const int k0 = j * LOOKBACK_CHUNKS, k1 = min(nchunks, k0 + LOOKBACK_CHUNKS);
#else
    const int slab = blockIdx.x, bi = blockIdx.y, k0 = 0, k1 = nchunks;
#endif
    const int c0 = slab * CH;

    if (warp == 1) {
      if (lane == 0) {
        for (int k = k0; k < k1; ++k) {
          const int i = k - k0, s = i % STAGES;
          if (i >= STAGES) mbar_wait(empty(s), (i / STAGES - 1) & 1);
          if (i >= p.depth) {
            const int j = i - p.depth;    // the chunk `depth` back has landed
            mbar_wait(full(j % STAGES), (j / STAGES) & 1);
          }
          mbar_expect_tx(full(s), STAGE_BYTES);
          tma_load(smem_u32(stage_a(s)), &ma, full(s), c0, k * TC, bi);
          tma_load(smem_u32(stage_a(s) + CHUNK_BYTES), &mb, full(s), c0, k * TC, bi);
        }
      }
      return;
    }

    float h[N], prod[N];
    for (int e = 0; e < N; ++e) h[e] = 0.f, prod[e] = 1.f;
#if LOOKBACK_CHUNKS
    // first pass from a zero state: the tile's aggregate, nothing written
    for (int k = k0; k < k1; ++k) {
      const int s = (k - k0) % STAGES;
      mbar_wait(full(s), 0);
      const uint32_t* a = reinterpret_cast<const uint32_t*>(stage_a(s)) + lane;
      scan_chunk<T, true>(a, const_cast<uint32_t*>(a) + CHUNK_BYTES / 4, h, prod);
    }
    for (int e = 0; e < N; ++e) {
      g_prod[my_tile][N * lane + e] = prod[e];
      g_agg[my_tile][N * lane + e] = h[e];
    }
    float carry[N];
    for (int e = 0; e < N; ++e) carry[e] = 0.f;
    if (j > 0) {
      __threadfence();
      __syncwarp();
      if (lane == 0) *reinterpret_cast<volatile int*>(&g_status[my_tile]) = 1;
      look_back<N>(my_tile, rows, lane, carry);
    }
    for (int e = 0; e < N; ++e) g_incl[my_tile][N * lane + e] = step(prod[e], carry[e], h[e]);
    __threadfence();
    __syncwarp();
    if (lane == 0) *reinterpret_cast<volatile int*>(&g_status[my_tile]) = 2;
    for (int e = 0; e < N; ++e) h[e] = carry[e];
#endif
    for (int k = k0; k < k1; ++k) {
      const int i = k - k0, s = i % STAGES;
      mbar_wait(full(s), (i / STAGES) & 1);
      uint32_t* a = reinterpret_cast<uint32_t*>(stage_a(s)) + lane;
      scan_chunk<T, false>(a, a + CHUNK_BYTES / 4, h, prod);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        tma_store(&mh, smem_u32(stage_a(s) + CHUNK_BYTES), c0, k * TC, bi);
        bulk_commit();
        if (i > 0) {
          bulk_wait_read<1>();          // the previous chunk's h has left shared memory
          mbar_arrive(empty((i - 1) % STAGES));
        }
      }
    }
    if (lane == 0) bulk_wait_all();
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

// a (B, S, W) tensor with element strides (batch, time), read and written in
// boxes of one 128-byte row of channels x TC steps of one batch row; a size-1
// axis gets a stride TMA takes, since it is never stepped along
template <typename T>
bool encode(CUtensorMap* map, const void* base, int B, int S, int W, const int64_t* st) {
  EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t row = ((cuuint64_t)W * sizeof(T) + 15) / 16 * 16;
  const cuuint64_t s_t = S > 1 ? (cuuint64_t)st[1] * sizeof(T) : row;
  const cuuint64_t s_b = B > 1 ? (cuuint64_t)st[0] * sizeof(T) : s_t * (cuuint64_t)S;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {s_t, s_b};
  const cuuint32_t box[3] = {(cuuint32_t)(ROW / sizeof(T)), (cuuint32_t)TC, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, Word<T>::TMA_TYPE, 3, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// returned when cuTensorMapEncodeTiled refuses a tensor map (no CUDA error code says so)
constexpr int TENSOR_MAP_REFUSED = -1;

template <typename T>
int launch(Params p, bool use_tma, cudaStream_t st) {
  const dim3 grid((p.W * sizeof(T) + ROW - 1) / ROW, p.B);
  CUtensorMap ma{}, mb{}, mh{};
  if (!use_tma) {
    rglru_fwd<T, false><<<grid, THREADS, 0, st>>>(ma, mb, mh, p);
    return cudaGetLastError();
  }
  if (!encode<T>(&ma, p.a, p.B, p.S, p.W, p.sa) || !encode<T>(&mb, p.b, p.B, p.S, p.W, p.sb) ||
      !encode<T>(&mh, p.h, p.B, p.S, p.W, p.sh))
    return TENSOR_MAP_REFUSED;
  int dev, sms;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  p.depth = LOOKBACK_CHUNKS || (int)(grid.x * grid.y) <= sms ? STAGES : 1;
  auto kernel = rglru_fwd<T, true>;
  err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
#if LOOKBACK_CHUNKS
  const int tiles = grid.x * grid.y * ((p.S + TC * LOOKBACK_CHUNKS - 1) / (TC * LOOKBACK_CHUNKS));
  if (tiles > MAX_TILES) return cudaErrorInvalidValue;
  void *ticket, *status;
  if ((err = cudaGetSymbolAddress(&ticket, g_ticket)) != cudaSuccess ||
      (err = cudaGetSymbolAddress(&status, g_status)) != cudaSuccess ||
      (err = cudaMemsetAsync(ticket, 0, sizeof(int), st)) != cudaSuccess ||
      (err = cudaMemsetAsync(status, 0, tiles * sizeof(int), st)) != cudaSuccess)
    return err;
  kernel<<<dim3(grid.x, grid.y * (tiles / (grid.x * grid.y))), THREADS, SMEM_BYTES, st>>>(
      ma, mb, mh, p);
#else
  kernel<<<grid, THREADS, SMEM_BYTES, st>>>(ma, mb, mh, p);
#endif
  return cudaGetLastError();
}

}  // namespace

// a, b, h: (B, S, W) with the channel stride 1; strides holds the (batch,
// time) element strides of a, b and h.  dtype 0 = fp32, 1 = bf16.  use_tma 1
// takes the TMA path (the wrapper checks that TMA can describe all three
// tensors), 0 the plain loads.  Returns the launch's CUDA error code (0 on
// success), or -1 if cuTensorMapEncodeTiled refused a tensor map.
extern "C" int rglru_scan_fwd(const void* a, const void* b, void* h, int dtype, int B, int S,
                              int W, const int64_t* strides, int use_tma, void* stream) {
  Params p;
  p.a = a;
  p.b = b;
  p.h = h;
  p.B = B;
  p.S = S;
  p.W = W;
  p.depth = STAGES;
  int64_t* dst[3] = {p.sa, p.sb, p.sh};
  for (int t = 0; t < 3; ++t)
    for (int i = 0; i < 2; ++i) dst[t][i] = strides[2 * t + i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, use_tma != 0, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, use_tma != 0, st);
  return (int)cudaErrorInvalidValue;
}
