// mmad: C = A @ B with fp32 accumulation, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `repro/kernels/mmad.py:_mmad_kernel`. That
// kernel walks an (M/bm, N/bn, K/bk) grid in order on one TensorCore and
// carries an fp32 VMEM accumulator across the sequential K axis. Here CTAs
// run in parallel and in no order, so a CTA loops over its K range itself,
// and where K is split across CTAs the partial sums meet in fp32 in a fixed
// order. Ragged edges are masked and A and B are read through their strides,
// so the wrapper never pads or copies (the tied lm_head weight is the
// strided view embed.T).
//
// Three variants. Two stream kernels for up to 16 rows of A with a weight
// whose rows (row stream) or columns (column stream, embed.T) are contiguous
// and 16-byte aligned: every decode GEMM. A 64 x 64 tile kernel for the
// rest, which stages fp32 tiles in shared memory, takes any strides, and
// sums a K split in a second kernel (mmad_splitk_reduce).
//
// What bounds the decode GEMMs on this card: at M = 4 the product reads the
// weight B once and does 8 FLOPs per weight element, far below the H100's
// ~295 FLOP/byte ridge, so device-memory bytes bound it (3.35 TB/s); tensor
// cores would buy nothing. The small ones (a 1-8 MB weight) are bound by
// fixed costs: the launch, A's staging, the first loads' latency, the split
// hand-off. What the stream kernels do about it:
//
//   * A staged once: a CTA converts its rows of A x its whole K range (at
//     most 2048 k) to fp32 in shared memory before it streams, so no
//     barrier stops the weight's loads;
//   * bytes in flight: the row stream loads the weight straight into
//     registers, 8 rows of 16 bytes per thread per batch with the next batch
//     in flight (32 KB per CTA, two CTAs per SM); its first batch is issued
//     before A is staged. The column stream feeds one shared-memory ring per
//     consumer warp from a producer warp with 1-D bulk copies
//     (cp.async.bulk, completion counted in bytes on an mbarrier), one 2 KB
//     copy per column of an item;
//   * a full-card grid with the split fixed up in the same launch: the row
//     stream's tile is 128 bytes of a k row, so a (K, N) weight has N / 64
//     (bf16) tiles, and K splits only until the tiles fill the SMs; the
//     column stream likewise. Every split writes an fp32 partial and counts
//     its arrival on its output tile's counter; the last to arrive sums the
//     partials in split order, writes C with one rounding and resets the
//     counter to zero: one kernel per call, bitwise repeatable results.
//
// The plan's block geometry does not shape the stream kernels (the tile
// kernel reads only bk, as its split-K unit).
//
// Numerics: every operand element converts exactly to fp32 (fp32, bf16,
// fp16, fp8 e4m3, int8), products and sums are IEEE fp32 FMAs on the CUDA
// cores (never TF32), and the output is rounded once to out_dtype.
//
// Plain C interface (bound with ctypes); launches on the caller's stream and
// returns the launch's cudaError.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <cstring>

namespace {

// dtype codes shared with kernels/mmad.py
enum Dt : int { F32 = 0, BF16 = 1, F16 = 2, F8E4M3 = 3, I8 = 4 };

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }
template <> __device__ __forceinline__ float to_f32<__nv_fp8_e4m3>(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t x) { return static_cast<float>(x); }

// A is small on the decode path (M rows of activations), so its dtype is a
// runtime switch; B, the streamed weight, is a template parameter.
__device__ __forceinline__ float load_any(const void* p, long long i, int dt) {
  switch (dt) {
    case F32: return static_cast<const float*>(p)[i];
    case BF16: return to_f32(static_cast<const __nv_bfloat16*>(p)[i]);
    case F16: return to_f32(static_cast<const __half*>(p)[i]);
    case F8E4M3: return to_f32(static_cast<const __nv_fp8_e4m3*>(p)[i]);
    default: return to_f32(static_cast<const int8_t*>(p)[i]);
  }
}

__device__ __forceinline__ void store_any(void* p, long long i, int dt, float v) {
  if (dt == F32) {
    static_cast<float*>(p)[i] = v;
  } else if (dt == BF16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  } else {
    static_cast<__half*>(p)[i] = __float2half(v);
  }
}

// A thread's share of an R x C tile: element i sits at (r0 + i*dr, c0 + i*dc).
// Threads run fastest along the operand's contiguous dim, so a warp reads
// consecutive addresses, and each thread's addresses advance by one fixed
// stride (one 64-bit offset per operand, not one per element).
struct TileWalk {
  int r0, c0, dr, dc;
  __device__ TileWalk(int tid, int R, int C, int NT, bool col_fast) {
    if (col_fast) {
      r0 = tid / C; c0 = tid % C; dr = NT / C; dc = 0;
    } else {
      r0 = tid % R; c0 = tid / R; dr = 0; dc = NT / R;
    }
  }
};

// One CTA computes a BM x BN tile of C over K range [kbeg, kend).
// Thread (ty, tx) owns rows ty + i*RY (i < TM) and cols tx + j*TX (j < TN).
template <int BM, int BN, int BK, int TM, int TN, typename TB>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
mmad_tile_kernel(const void* __restrict__ A, const TB* __restrict__ B,
                 void* __restrict__ C, float* __restrict__ ws, int a_dt, int c_dt,
                 long long M, long long N, long long K, long long sam, long long sak,
                 long long sbk, long long sbn, long long kps, int splits) {
  constexpr int RY = BM / TM;          // thread rows
  constexpr int TX = BN / TN;          // thread cols
  constexpr int NT = RY * TX;
  constexpr int A_PT = BM * BK / NT;
  constexpr int B_PT = BK * BN / NT;
  static_assert(BM * BK % NT == 0 && BK * BN % NT == 0, "tile / thread split");
  static_assert(NT % BM == 0 && NT % BK == 0 && NT % BN == 0, "tile walks");
  // +1 padding: loads that run fastest along k store down a column without
  // bank conflicts, and row reads stay conflict-free
  __shared__ float As[BK][BM + 1];     // A tile, k-major
  __shared__ float Bs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const long long n0 = static_cast<long long>(blockIdx.x) * BN;
  const long long kbeg = static_cast<long long>(blockIdx.z) * kps;
  const long long kend = (kbeg + kps < K) ? kbeg + kps : K;

  // A tile: rows m, cols k; B tile: rows k, cols n
  const TileWalk wa(tid, BM, BK, NT, sak == 1 && sam != 1);
  const TileWalk wb(tid, BK, BN, NT, !(sbk == 1 && sbn != 1));
  const long long a_base = (m0 + wa.r0) * sam + wa.c0 * sak;
  const long long a_step = wa.dr * sam + wa.dc * sak;
  const long long b_base = wb.r0 * sbk + (n0 + wb.c0) * sbn;
  const long long b_step = wb.dr * sbk + wb.dc * sbn;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float ra[A_PT];
  float rb[B_PT];

  auto load = [&](long long k0) {
    const long long a_off = a_base + k0 * sak;
#pragma unroll
    for (int i = 0; i < A_PT; ++i) {
      const bool ok = m0 + wa.r0 + i * wa.dr < M && k0 + wa.c0 + i * wa.dc < kend;
      ra[i] = ok ? load_any(A, a_off + i * a_step, a_dt) : 0.f;
    }
    const TB* bp = B + b_base + k0 * sbk;
#pragma unroll
    for (int i = 0; i < B_PT; ++i) {
      const bool ok = k0 + wb.r0 + i * wb.dr < kend && n0 + wb.c0 + i * wb.dc < N;
      rb[i] = ok ? to_f32<TB>(bp[i * b_step]) : 0.f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < A_PT; ++i) As[wa.c0 + i * wa.dc][wa.r0 + i * wa.dr] = ra[i];
#pragma unroll
    for (int i = 0; i < B_PT; ++i) Bs[wb.r0 + i * wb.dr][wb.c0 + i * wb.dc] = rb[i];
  };

  if (kbeg < kend) {
    load(kbeg);
    store();
    __syncthreads();
    for (long long k0 = kbeg; k0 < kend; k0 += BK) {
      const bool more = k0 + BK < kend;
      if (more) load(k0 + BK);           // next tile's loads fly during compute
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float av[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = As[kk][ty + i * RY];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + j * TX];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
      if (more) {
        store();
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty + i * RY;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long n = n0 + tx + j * TX;
      if (m < M && n < N) {
        if (splits == 1) {
          store_any(C, m * N + n, c_dt, acc[i][j]);
        } else {
          ws[(static_cast<long long>(blockIdx.z) * M + m) * N + n] = acc[i][j];
        }
      }
    }
  }
}

// Sum the split-K partials in split order and cast to out_dtype.
__global__ void mmad_splitk_reduce(const float* __restrict__ ws, void* __restrict__ C,
                                   int c_dt, long long MN, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += ws[z * MN + i];
  store_any(C, i, c_dt, s);
}

// ---------------------------------------------------------------------------
// Stream kernels for few rows of A (decode): the weight B is read once, and
// the CTA's rows of A x its K range are staged once as fp32 in shared
// memory. A K split is fixed up in the same launch: every split writes an
// fp32 partial, counts its arrival on its output tile's counter, and the
// last to arrive sums the partials in split order and writes C.
// ---------------------------------------------------------------------------

constexpr int SK_MT = 4;                     // rows of A per CTA
constexpr int SK_WARPS = 8;                  // consumer warps per CTA
constexpr int SK_CONSUMERS = SK_WARPS * 32;
constexpr int SK_NT = SK_CONSUMERS + 32;     // + one producer warp
constexpr int SK_COLS = 4;                   // columns per column-stream item
constexpr int COL_STAGE_BYTES = 8192, COL_STAGES = 2;   // one ring per consumer warp
constexpr int ROW_NT = SK_CONSUMERS;         // row stream: no producer warp
constexpr int ROW_VECS = 8;                  // row-stream tile: 8 vectors, 128 B of a k row
constexpr int ROW_BATCH = 8;                 // k rows a row-stream thread has in flight

struct StreamArgs {
  const void* A;
  const void* B;
  void* C;
  float* ws;          // fp32 partials of a K split: (splits, M, N)
  int* counters;      // one arrival counter per output tile; zero between launches
  int a_dt, c_dt;
  long long M, N, K, sam, sak, sbk, sbn;
  long long kps;      // k per split
  int splits;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
// Returns once the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
// One contiguous global -> shared copy, completing `bytes` on the barrier.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// Counts one arrival of a split on its output tile's counter at device
// scope, releasing the split's partial (its stores are ordered before the
// call by the caller's barrier) and acquiring the earlier splits'; true for
// the last of `splits`, which resets the counter to zero for the next
// launch and may then read every split's partial once its barrier has
// ordered its readers after the call.
__device__ __forceinline__ bool arrive_last(int* counter, int splits) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  if (old != splits - 1) return false;
  *counter = 0;
  return true;
}

// The sum, in split order 0..splits-1, of the partials at[z * step]: eight
// loads in flight, all issued before any is added (more cost the row stream
// registers, and it spilled).
__device__ __forceinline__ float sum_splits(const float* at, long long step, int splits) {
  constexpr int B = 8;
  float sum = 0.f;
  for (int z0 = 0; z0 < splits; z0 += B) {
    float v[B];
#pragma unroll
    for (int i = 0; i < B; ++i) v[i] = z0 + i < splits ? __ldcg(at + (z0 + i) * step) : 0.f;
#pragma unroll
    for (int i = 0; i < B; ++i)
      if (z0 + i < splits) sum += v[i];
  }
  return sum;
}

// The consumer warps only (the producer may still be issuing copies).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(SK_CONSUMERS) : "memory");
}

// A ring of `stages` slots with a full and an empty barrier each. Stage s
// goes to slot s % stages; every consumer of the ring consumes its stages in
// order, so a wait never runs a whole phase ahead of its barrier.
struct Ring {
  unsigned char* slots;
  uint64_t* full;
  uint64_t* empty;
  int stage_bytes, stages;
  __device__ Ring(unsigned char* slots_, uint64_t* bars, int stage_bytes_, int stages_)
      : slots(slots_), full(bars), empty(bars + stages_), stage_bytes(stage_bytes_),
        stages(stages_) {}
  __device__ void init(int empty_arrivals) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], empty_arrivals);
    }
  }
  __device__ unsigned char* slot(int s) const {
    return slots + static_cast<long long>(s % stages) * stage_bytes;
  }
  // The producer waits until stage s's slot is free, then arms it.
  __device__ void produce(int s, uint32_t bytes) {
    mbar_wait(&empty[s % stages], ((s / stages) & 1) ^ 1);
    if ((threadIdx.x & 31) == 0) mbar_expect_tx(&full[s % stages], bytes);
    __syncwarp();
  }
  __device__ void wait_full(int s) { mbar_wait(&full[s % stages], (s / stages) & 1); }
  __device__ void release(int s) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s % stages]);
  }
};

// The CTA's rows m0.. of A x its K range [kbeg, kbeg + klen) as fp32 at
// As[dst(row, k)], by threads 0..SK_CONSUMERS-1: each issues SA loads before it
// converts and stores any, so the staging costs a few memory latencies.
template <typename TA, typename Dst>
__device__ __forceinline__ void stage_a_typed(const StreamArgs& p, float* As, long long m0,
                                              long long kbeg, int klen, Dst dst) {
  constexpr int SA = 16;
  const TA* A = static_cast<const TA*>(p.A);
  const int total = SK_MT * klen;
  for (int base = threadIdx.x; base < total; base += SA * SK_CONSUMERS) {
    TA v[SA];
#pragma unroll
    for (int u = 0; u < SA; ++u) {
      const int idx = base + u * SK_CONSUMERS;
      const int r = idx / klen, kk = idx - r * klen;
      v[u] = (idx < total && m0 + r < p.M) ? A[(m0 + r) * p.sam + (kbeg + kk) * p.sak] : TA();
    }
#pragma unroll
    for (int u = 0; u < SA; ++u) {
      const int idx = base + u * SK_CONSUMERS;
      const int r = idx / klen;
      if (idx < total) As[dst(r, idx - r * klen)] = to_f32<TA>(v[u]);
    }
  }
}

template <typename Dst>
__device__ __forceinline__ void stage_a(const StreamArgs& p, float* As, long long m0,
                                        long long kbeg, int klen, Dst dst) {
  switch (p.a_dt) {
    case F32: stage_a_typed<float>(p, As, m0, kbeg, klen, dst); break;
    case BF16: stage_a_typed<__nv_bfloat16>(p, As, m0, kbeg, klen, dst); break;
    case F16: stage_a_typed<__half>(p, As, m0, kbeg, klen, dst); break;
    case F8E4M3: stage_a_typed<__nv_fp8_e4m3>(p, As, m0, kbeg, klen, dst); break;
    default: stage_a_typed<int8_t>(p, As, m0, kbeg, klen, dst); break;
  }
}

// The 16 bytes of one vector of B as fp32.
template <typename TB>
__device__ __forceinline__ void to_f32_vec(const uint4& raw, float (&out)[16 / sizeof(TB)]) {
  TB e[16 / sizeof(TB)];
  memcpy(e, &raw, 16);
#pragma unroll
  for (int v = 0; v < 16 / static_cast<int>(sizeof(TB)); ++v) out[v] = to_f32<TB>(e[v]);
}

__device__ __forceinline__ float* partial(const StreamArgs& p, long long m, long long n) {
  return p.ws + (static_cast<long long>(blockIdx.z) * p.M + m) * p.N + n;
}

// B row-major (n contiguous, 16-byte aligned rows). A CTA owns a tile of
// ROW_VECS column vectors (128 bytes of each k row) over a split's K range;
// thread t loads column vector t % ROW_VECS of every G-th k row (row group
// t / ROW_VECS) straight into registers, U rows per batch, the next batch
// in flight while the current one is summed. The first batch is issued
// before A is staged, so the weight is already on its way. Row groups meet
// in warp shuffles, then warps in shared memory, in a fixed order. A split
// CTA writes an fp32 partial and the last of the tile's splits to arrive
// sums them in split order and writes C.
template <typename TB>
__global__ void __launch_bounds__(ROW_NT, sizeof(TB) == 1 ? 1 : 2)
    mmad_rows_kernel(const StreamArgs p) {
  constexpr int VEC = 16 / sizeof(TB);
  constexpr int TILE = ROW_VECS * VEC;          // columns per CTA
  constexpr int G = ROW_NT / ROW_VECS;          // row groups
  constexpr int U = ROW_BATCH;                  // k rows per thread per batch
  extern __shared__ __align__(128) unsigned char smem[];
  const float4* As = reinterpret_cast<const float4*>(smem);   // [k - kbeg]: rows m0..m0+3
  float* red = reinterpret_cast<float*>(smem + 16 * p.kps);   // [warp][SK_MT][TILE]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cv = threadIdx.x % ROW_VECS;
  const int rg = threadIdx.x / ROW_VECS;
  const long long m0 = static_cast<long long>(blockIdx.y) * SK_MT;
  const long long c0 = static_cast<long long>(blockIdx.x) * TILE;
  const long long kbeg = static_cast<long long>(blockIdx.z) * p.kps;
  const int klen = static_cast<int>((kbeg + p.kps < p.K) ? p.kps : p.K - kbeg);
  // N is whole vectors, so a vector is wholly in B or wholly past its edge
  const bool in_b = c0 + cv * VEC < p.N;
  const TB* bp = static_cast<const TB*>(p.B) + kbeg * p.sbk + c0 + cv * VEC;

  auto load = [&](int k0, uint4 (&buf)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = k0 + rg + u * G;
      buf[u] = (in_b && kk < klen) ? __ldg(reinterpret_cast<const uint4*>(bp + kk * p.sbk))
                                   : make_uint4(0, 0, 0, 0);
    }
  };
  uint4 cur[U];
  load(0, cur);
  stage_a(p, reinterpret_cast<float*>(smem), m0, kbeg, klen,
          [](int r, int kk) { return kk * SK_MT + r; });
  __syncthreads();

  float acc[SK_MT][VEC];
#pragma unroll
  for (int m = 0; m < SK_MT; ++m)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[m][v] = 0.f;
  for (int k0 = 0; k0 < klen; k0 += U * G) {
    uint4 nxt[U];
    if (k0 + U * G < klen) load(k0 + U * G, nxt);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = k0 + rg + u * G;
      if (kk < klen) {
        float b[VEC];
        to_f32_vec<TB>(cur[u], b);
        const float4 a = As[kk];
        const float av[SK_MT] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int m = 0; m < SK_MT; ++m)
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[m][v] = fmaf(av[m], b[v], acc[m][v]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = nxt[u];
  }

#pragma unroll
  for (int off = ROW_VECS; off < 32; off <<= 1)
#pragma unroll
    for (int m = 0; m < SK_MT; ++m)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[m][v] += __shfl_xor_sync(0xffffffffu, acc[m][v], off);
  if (lane < ROW_VECS)
#pragma unroll
    for (int m = 0; m < SK_MT; ++m)
#pragma unroll
      for (int v = 0; v < VEC; ++v) red[(warp * SK_MT + m) * TILE + cv * VEC + v] = acc[m][v];
  __syncthreads();

  const int splits = static_cast<int>(gridDim.z);
  for (int idx = threadIdx.x; idx < SK_MT * TILE; idx += ROW_NT) {
    const int m = idx / TILE, c = idx % TILE;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < ROW_NT / 32; ++w) sum += red[(w * SK_MT + m) * TILE + c];
    if (m0 + m < p.M && c0 + c < p.N) {
      if (splits == 1) {
        store_any(p.C, (m0 + m) * p.N + c0 + c, p.c_dt, sum);
      } else {
        __stcg(partial(p, m0 + m, c0 + c), sum);
      }
    }
  }
  if (splits == 1) return;
  __shared__ int last;
  __syncthreads();                              // the CTA's partial is written
  if (threadIdx.x == 0)
    last = arrive_last(&p.counters[blockIdx.y * gridDim.x + blockIdx.x], splits);
  __syncthreads();
  if (!last) return;
  for (int idx = threadIdx.x; idx < SK_MT * TILE; idx += ROW_NT) {
    const long long m = m0 + idx / TILE, n = c0 + idx % TILE;
    if (m < p.M && n < p.N)
      store_any(p.C, m * p.N + n, p.c_dt, sum_splits(p.ws + m * p.N + n, p.M * p.N, splits));
  }
}

// B column-major (k contiguous, 16-byte aligned columns: the tied lm_head
// weight embed.T, read in place). An item is SK_COLS columns over the CTA's
// K range; the CTAs walk the items (grid-stride), and item j of a CTA
// belongs to consumer warp j % SK_WARPS, which has a ring of its own (warps
// run items at their own pace). A stage is one item's columns x KC
// consecutive k, one bulk copy per column. The warp's lanes split K, holding the staged A
// of their k in registers across the SK_COLS columns, and meet in a warp
// shuffle. The staged A is laid out [row][VEC/4][k/VEC][4], so a lane's
// 16-byte reads of it are consecutive across the warp.
template <typename TB>
__global__ void __launch_bounds__(SK_NT, 1) mmad_cols_kernel(const StreamArgs p) {
  constexpr int VEC = 16 / sizeof(TB);
  constexpr int H = VEC / 4;
  constexpr int KC = COL_STAGE_BYTES / (SK_COLS * sizeof(TB));
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long m0 = static_cast<long long>(blockIdx.y) * SK_MT;
  const long long kbeg = static_cast<long long>(blockIdx.z) * p.kps;
  const int klen = static_cast<int>((kbeg + p.kps < p.K) ? p.kps : p.K - kbeg);
  const int nchunk = (klen + KC - 1) / KC;
  const long long groups = (p.N + SK_COLS - 1) / SK_COLS;
  const int items =
      static_cast<int>((groups - blockIdx.x + gridDim.x - 1) / gridDim.x);
  const int nkv = static_cast<int>(p.kps / VEC);
  float4* As = reinterpret_cast<float4*>(smem);
  unsigned char* slots = smem + 16 * p.kps;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(slots + SK_WARPS * COL_STAGES * COL_STAGE_BYTES);
  auto ring_of = [&](int w) {
    return Ring(slots + w * COL_STAGES * COL_STAGE_BYTES, bars + w * 2 * COL_STAGES,
                COL_STAGE_BYTES, COL_STAGES);
  };
  if (threadIdx.x == 0) {
    for (int w = 0; w < SK_WARPS; ++w) ring_of(w).init(1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == SK_WARPS) {                       // producer: chunk c of every warp's
    for (int q = 0; q * SK_WARPS < items; ++q)  // item before chunk c + 1 of any
      for (int c = 0; c < nchunk; ++c) {
        const int s = q * nchunk + c;           // the warp's own stage count
        const int clen = (klen - c * KC < KC) ? klen - c * KC : KC;
        const uint32_t seg = static_cast<uint32_t>(clen * sizeof(TB));
        for (int w = 0; w < SK_WARPS && q * SK_WARPS + w < items; ++w) {
          Ring ring = ring_of(w);
          const long long n0 =
              (blockIdx.x + static_cast<long long>(q * SK_WARPS + w) * gridDim.x) * SK_COLS;
          const int ncols = static_cast<int>((p.N - n0 < SK_COLS) ? p.N - n0 : SK_COLS);
          ring.produce(s, ncols * seg);
          if (lane < ncols)
            bulk_load(ring.slot(s) + lane * KC * sizeof(TB),
                      static_cast<const TB*>(p.B) + (n0 + lane) * p.sbn + kbeg + c * KC, seg,
                      &ring.full[s % ring.stages]);
        }
      }
    return;
  }
  Ring ring = ring_of(warp);

  stage_a(p, reinterpret_cast<float*>(As), m0, kbeg, klen, [nkv](int r, int kk) {
    const int e = kk % VEC;
    return ((r * H + e / 4) * nkv + kk / VEC) * 4 + e % 4;
  });
  consumer_sync();

  for (int j = warp; j < items; j += SK_WARPS) {
    float acc[SK_MT][SK_COLS];
#pragma unroll
    for (int m = 0; m < SK_MT; ++m)
#pragma unroll
      for (int c = 0; c < SK_COLS; ++c) acc[m][c] = 0.f;
    for (int c = 0; c < nchunk; ++c) {
      const int s = (j / SK_WARPS) * nchunk + c;
      const int nv = ((klen - c * KC < KC) ? klen - c * KC : KC) / VEC;
      const int kv0 = c * (KC / VEC);
      ring.wait_full(s);
      const unsigned char* st = ring.slot(s);
      for (int v = lane; v < nv; v += 32) {
        float a[SK_MT][VEC];
#pragma unroll
        for (int m = 0; m < SK_MT; ++m)
#pragma unroll
          for (int h = 0; h < H; ++h) {
            const float4 t = As[(m * H + h) * nkv + kv0 + v];
            a[m][4 * h] = t.x;
            a[m][4 * h + 1] = t.y;
            a[m][4 * h + 2] = t.z;
            a[m][4 * h + 3] = t.w;
          }
#pragma unroll
        for (int col = 0; col < SK_COLS; ++col) {
          float b[VEC];
          to_f32_vec<TB>(*reinterpret_cast<const uint4*>(st + col * KC * sizeof(TB) + v * 16), b);
#pragma unroll
          for (int m = 0; m < SK_MT; ++m)
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[m][col] = fmaf(a[m][e], b[e], acc[m][col]);
        }
      }
      ring.release(s);
    }

    // every lane ends with every sum; lane l keeps row l / SK_COLS, column l % SK_COLS
    float out = 0.f;
#pragma unroll
    for (int m = 0; m < SK_MT; ++m)
#pragma unroll
      for (int col = 0; col < SK_COLS; ++col) {
        float x = acc[m][col];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
        if (lane == m * SK_COLS + col) out = x;
      }
    const long long g = blockIdx.x + static_cast<long long>(j) * gridDim.x;
    const long long m = m0 + lane / SK_COLS, n = g * SK_COLS + lane % SK_COLS;
    const bool ok = lane < SK_MT * SK_COLS && m < p.M && n < p.N;
    if (p.splits == 1) {
      if (ok) store_any(p.C, m * p.N + n, p.c_dt, out);
      continue;
    }
    if (ok) __stcg(partial(p, m, n), out);
    __syncwarp();                               // the warp's partial is written
    int last = 0;
    if (lane == 0) last = arrive_last(&p.counters[blockIdx.y * groups + g], p.splits);
    last = __shfl_sync(0xffffffffu, last, 0);
    __syncwarp();                               // orders the lanes' reads after lane 0's
    if (last && ok)
      store_any(p.C, m * p.N + n, p.c_dt, sum_splits(p.ws + m * p.N + n, p.M * p.N, p.splits));
  }
}

// grid: (grid_x column tiles or item walkers, groups of SK_MT rows of A,
// K splits)
template <typename TB>
int launch_stream(int variant, const StreamArgs& p, int grid_x, cudaStream_t stream) {
  const dim3 grid(grid_x, static_cast<unsigned>((p.M + SK_MT - 1) / SK_MT), p.splits);
  if (variant == 1) {
    // A staged, then the warps' sums: at most 48 KB (kps <= 2048)
    constexpr size_t red = (ROW_NT / 32) * SK_MT * ROW_VECS * (16 / sizeof(TB)) * sizeof(float);
    const size_t smem = 16 * static_cast<size_t>(p.kps) + red;
    mmad_rows_kernel<TB><<<grid, ROW_NT, smem, stream>>>(p);
    return 0;
  }
  // a column-stream CTA holds more than the default 48 KB: raise its limit
  // once per device
  const size_t smem = 16 * static_cast<size_t>(p.kps) +
                      SK_WARPS * COL_STAGES * (COL_STAGE_BYTES + 2 * 8);
  static int limit[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (limit[dev] < static_cast<int>(smem)) {
    err = cudaFuncSetAttribute(mmad_cols_kernel<TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    limit[dev] = static_cast<int>(smem);
  }
  mmad_cols_kernel<TB><<<grid, SK_NT, smem, stream>>>(p);
  return 0;
}

// variant 0: tile, 64 x 64, a 4 x 4 register block per thread, split K
// summed by mmad_splitk_reduce; variant 1: row stream (B n-contiguous,
// 16-byte aligned); variant 2: column stream (B k-contiguous, 16-byte
// aligned). The stream variants fix their split up themselves.
template <typename TB>
int launch_typed(int variant, const StreamArgs& p, int grid_x, cudaStream_t stream) {
  if (variant == 1 || variant == 2) return launch_stream<TB>(variant, p, grid_x, stream);
  constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, p.splits);
  mmad_tile_kernel<BM, BN, BK, TM, TN, TB><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
      p.A, static_cast<const TB*>(p.B), p.C, p.ws, p.a_dt, p.c_dt, p.M, p.N, p.K, p.sam,
      p.sak, p.sbk, p.sbn, p.kps, p.splits);
  if (p.splits > 1) {
    const long long mn = p.M * p.N;
    const int threads = 256;
    mmad_splitk_reduce<<<static_cast<unsigned>((mn + threads - 1) / threads), threads, 0,
                         stream>>>(p.ws, p.C, p.c_dt, mn, p.splits);
  }
  return 0;
}

}  // namespace

extern "C" int mmad_launch(const void* a, const void* b, void* c, void* ws, void* counters,
                           int a_dt, int b_dt, int c_dt, long long M, long long N, long long K,
                           long long sam, long long sak, long long sbk, long long sbn,
                           long long kps, int splits, int variant, int grid_x,
                           void* stream_ptr) {
  const StreamArgs p{a, b, c, static_cast<float*>(ws), static_cast<int*>(counters), a_dt, c_dt,
                     M, N, K, sam, sak, sbk, sbn, kps, splits};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int err;
  switch (b_dt) {
    case F32: err = launch_typed<float>(variant, p, grid_x, stream); break;
    case BF16: err = launch_typed<__nv_bfloat16>(variant, p, grid_x, stream); break;
    case F16: err = launch_typed<__half>(variant, p, grid_x, stream); break;
    case F8E4M3: err = launch_typed<__nv_fp8_e4m3>(variant, p, grid_x, stream); break;
    case I8: err = launch_typed<int8_t>(variant, p, grid_x, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return err ? err : static_cast<int>(cudaGetLastError());
}
