// mmad: C = A @ B with fp32 accumulation, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `repro/kernels/mmad.py:_mmad_kernel`. That
// kernel walks an (M/bm, N/bn, K/bk) grid in order on one TensorCore and
// carries an fp32 VMEM accumulator across the sequential K axis, its
// products `jnp.dot(..., preferred_element_type=float32)` on the MXU. Here
// CTAs run in parallel and in no order, so a CTA loops over its K range
// itself, and where K is split across CTAs the partial sums meet in fp32 in
// a fixed order. Ragged edges are masked and A and B are read through their
// strides, so the wrapper never pads or copies (the tied lm_head weight is
// the strided view embed.T).
//
// Five variants. Two stream kernels for up to 16 rows of A with a weight
// whose rows (row stream) or columns (column stream, embed.T) are contiguous
// and 16-byte aligned: every decode GEMM. A tensor-core tile kernel (wgmma
// fed by TMA) for more rows of bf16 or fp16 operands that a tensor map can
// describe: every train GEMM. An fp8 tensor-core kernel (wgmma on e4m3,
// with a transpose kernel before it for an N-major B) for more rows of fp8
// e4m3 operands that a tensor map can describe: the paper's fp8 GEMMs under
// softhier-gh200 plans. A SIMT tile kernel for the rest (fp32 and int8
// inputs, fp8 the fp8 kernel refuses, mixed dtypes, strides TMA cannot
// describe): on the main path the fp32 MoE router and xLSTM gates in
// training.
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
// What bounds the train GEMMs: M = 2048 tokens (1024 for an lm_head loss
// chunk) against K = 2048-16384 is ~680 FLOP per byte, far above the ridge,
// so operations bound them (989 TFLOPS bf16 dense), and only wgmma reaches
// the tensor cores' rate; CUDA cores top out at 67 TFLOPS fp32. What the
// tensor-core kernel does about it:
//
//   * the plan's CTA tile, or the route's own 128 x 256: one consumer
//     warpgroup per 64 rows, each issuing wgmma.m64n{64,128,256}k16 with
//     its 64 x BN fp32 accumulators in registers. At 128 x 256 (128 a
//     thread; setmaxnreg gives the consumers 232 registers and the producer
//     40) every byte staged in shared memory feeds 85 FLOPs. The tiles,
//     K steps and ring depths compiled are TC_INSTANCES: the instances a
//     plan priced on the card view (core/schedule.py) may name;
//   * operands never pass through registers: one producer thread keeps a
//     ring of 64-deep K steps (at 128 x 256, 4 stages of 48 KB: one
//     128-byte swizzle row of bf16 per row of A and per row or column of B) filled with TMA
//     tensor-map loads, counted in bytes on a full mbarrier per stage; a
//     consumer warp frees a stage on its empty mbarrier once the wgmma
//     group that read it has completed (one group kept in flight);
//   * B in either major, read in place: a (K, N) weight is N-contiguous
//     (BN / 64 64-column boxes a stage, wgmma transposes B), embed.T is
//     K-contiguous (one BN-row box, no transpose); the tensor maps
//     zero-fill every box that crosses the M, N or K edge, so nothing is
//     padded, and the epilogue masks its stores;
//   * A in either major, read in place too: an activation is K-contiguous,
//     but the backward's weight gradient db = a.T @ g reads a.T, which is
//     M-contiguous. That A loads as one 64-row box a stage per consumer
//     warpgroup, laid out as the N-contiguous B is, and wgmma's
//     transpose-A bit (bf16 and fp16 operands in shared memory) reads it.
//     Only the (A, B) majors the train path uses are built: (K, N) and
//     (K, K) for the forward and for da = g @ b.T, (MN, N) for every db;
//   * one CTA per output tile, K never split: on an H100, writing and
//     re-reading a 128 x 256 tile's fp32 partials cost more than the idle
//     SMs gave back at every split count tried, even where the tiles fill
//     an eighth of the card (gemma-2b's k/v projection, 16 tiles: 23.5 us
//     unsplit, 62.8 / 74.0 / 133 us at 2 / 4 / 8 splits).
//
// What bounds the paper's fp8 GEMMs: at M = 4096 against N = 2112-32768 and
// K = 512-16384, ~200 FLOP a byte, operations (1979 TFLOPS fp8 dense),
// which only wgmma on e4m3 reaches; at M = 64 or 128, B's bytes (3.35 TB/s).
// What the fp8 kernel does about it:
//
//   * the plan's CTA tile, or where the plan names none a 128 x 128 tile,
//     or 128 x 192 where its tiles take fewer waves
//     (kernels/mmad.py:fp8_tile_width): two consumer warpgroups each issue
//     wgmma.m64n{128,192}k32 into 64 or 96 fp32 accumulators a thread. A
//     128-byte swizzle row holds 128 e4m3, so a stage is 128 deep (a
//     32-deep slice is 32 bytes, the bf16 kernel's descriptor step); 6
//     stages of 32 KB or 5 of 40 KB. The wider tile feeds 157 FLOP a byte
//     of shared-memory fill, not 128: on an H100 the 128-wide tiles of the
//     long-K shapes stalled near 7 TB/s of fill;
//   * promotion: the tensor cores keep about 14 bits of an fp8 running sum
//     (DeepSeek-V3, arXiv:2412.19437, 3.3.2). Each consumer adds its
//     accumulator into fp32 registers on the CUDA cores after every 128-deep
//     K step (wgmma_wait<0>, then the adds) and restarts it from zero. On
//     an H100 the largest error against IEEE fp32 sums at K = 16384 was 0.090
//     with it and 5.63 without (tools/mmad_fp8_times.py). Two accumulators
//     alternating by step, chosen at run time, made ptxas serialize every
//     wgmma and ran 10-45 % slower;
//   * B K-major only: fp8 wgmma has no transpose bits, so a (K, N) weight is
//     first copied K-major into the call's workspace by a transpose kernel
//     that moves whole 128-byte lines both ways (4 x 4 byte blocks turned in
//     registers); ~2.7 TB/s on an H100. embed.T-like K-major weights are
//     read in place;
//   * K split only where the tiles leave SMs idle (the flat shapes: one M
//     tile), into as many splits as one wave holds; partial tiles are
//     written fragment by fragment in coalesced float4s and the last split
//     to arrive sums them in split order: one GEMM kernel a call, bitwise
//     repeatable.
//
// What bounds the SIMT tile route's main-path GEMMs: the train router (A
// 2048 x 2048 fp32 against a 2048 x 64 weight) is 32 FLOP per byte of A,
// above the CUDA cores' ridge (67 TFLOPS fp32 over 3.35 TB/s, 20 FLOP per
// byte, counting A once), so operations bound it (8.0 us); the gates (N =
// 8) are 4 FLOP per byte, bound by A's bytes (5.0 us). A is the one large
// operand and N is narrow. What the route does about it:
//
//   * a CTA tile sized by N: narrow instances (N <= 64) are 64 rows tall
//     and as wide as N rounded up to a power of two (8, 16, 32 or 64), so
//     no column is computed to be masked and A is streamed once; a wide
//     instance, 128 x 128, takes the rest. A CTA's 256 threads hold 8 x 8
//     (or, narrower, 8 x TN / 8) register blocks and form K slices, each
//     summing its share of every stage, so a narrow tile still has 256
//     threads; the slices meet in shared memory at the end;
//   * operands through a ring, not through registers: each stage, TILE_BK
//     = 32 k of A's rows and B's, is copied by 16-byte cp.async (zero-fill
//     past an edge) with STAGES - 1 stages in flight while one is summed,
//     one barrier a stage; fp32, bf16, fp16, fp8 e4m3 (what the fp8 kernel
//     refuses) and int8 are compile-time pairs of one dtype, converted to
//     fp32 as they are read from shared memory. Mixed dtypes and strides that deny 16-byte
//     vectors take one generic instance: scalar loads with runtime dtypes,
//     fetched into registers while the current stage is summed;
//   * K split from the shape and the SM count (kernels/mmad.py:
//     tile_geometry), in whole stages, until the CTAs fill the slots the
//     instance keeps on each SM: the router's narrow-64 instance takes up
//     to 255 registers and runs one CTA an SM (4 splits, 128 CTAs, no
//     spills: on an H100 23.1 us, against 27.3 us at two CTAs an SM with
//     128 registers and 8 splits); the gates' two (8 splits, 256 CTAs). Every
//     split writes a whole fp32 partial tile, counts its arrival on the
//     tile's counter, and the last to arrive sums the partials in split
//     order and writes C: one kernel a call, bitwise repeatable.
//
// The plan's inner kernel reaches the tensor-core kernels only: a launch
// given a geometry runs that TC_INSTANCES row (the wrapper refuses any
// other, and any geometry for operands the tensor cores do not take), and
// one given none runs the route's own. The stream kernels' tiles, splits
// and rings and the SIMT tile route's instance and split are their own:
// lowering on a CUDA mesh leaves no inner kernel on the products they take
// (core/lower.py, `inner_kernel_no_instance`).
//
// Numerics: every operand element converts exactly to fp32 (fp32, bf16,
// fp16, fp8 e4m3, int8), and the output is rounded once to out_dtype. On
// the SIMT kernels products and sums are IEEE fp32 FMAs on the CUDA cores
// (never TF32). On the tensor-core kernel bf16 and fp16 products are exact
// in fp32 too, but the tensor cores sum them, and their fp32 accumulation is
// not an IEEE FMA chain: the running sum is truncated, not rounded to
// nearest, at each 16-deep K slice. On the fp8 kernel e4m3 products are
// exact, the tensor cores sum each 32-deep slice keeping about 14 bits, and
// every 128-deep step's sum is added into IEEE fp32 registers.
//
// Plain C interface (bound with ctypes); launches on the caller's stream and
// returns the launch's cudaError.

#include <cuda.h>             // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <cstring>
#include <type_traits>

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

// ---------------------------------------------------------------------------
// Tensor-core tile kernel (wgmma fed by TMA) for bf16 / fp16 operands that a
// tensor map can describe: A K- or M-contiguous, B N- or K-contiguous (an
// M-contiguous A only with an N-contiguous B), 16-byte aligned bases and
// row strides. A CTA computes a BM x BN tile of C over all of K;
// warpgroup 0 is the producer (one thread issues the TMA loads), each of
// the BM / 64 consumer warpgroups owns 64 rows of the tile.
// ---------------------------------------------------------------------------

// The tensor-core instances this file compiles, the only geometries the
// two tensor-core kernels run: family (TC_16BIT: bf16 and fp16; TC_E4M3:
// fp8), CTA tile bm x bn, K step bk, ring stages. hw/config.py:
// H100_TC_INSTANCES is the card view's copy, which kernels/mmad.py holds
// this table to when it loads the library (mmad_instances); a launch
// names an instance by its index here and is refused for any other (it
// never falls back). The route's own: 16-bit
// index 0, fp8 6 and 7 by fp8_tile_width.
enum TcFamily : int { TC_16BIT = 0, TC_E4M3 = 1 };
struct TcInstance {
  int family, bm, bn, bk, stages;
};
constexpr TcInstance TC_INSTANCES[] = {
    {TC_16BIT, 128, 256, 64, 4}, {TC_16BIT, 128, 128, 64, 6}, {TC_16BIT, 128, 64, 64, 6},
    {TC_16BIT, 64, 256, 64, 5},  {TC_16BIT, 64, 128, 64, 6},  {TC_16BIT, 64, 64, 64, 6},
    {TC_E4M3, 128, 192, 128, 5}, {TC_E4M3, 128, 128, 128, 6},
};
constexpr int N_TC_INSTANCES = sizeof(TC_INSTANCES) / sizeof(TC_INSTANCES[0]);

constexpr int WG_BK = 64;                              // one 128-byte swizzle row of 16-bit
constexpr int WG_BOX_BYTES = WG_BK * 64 * 2;           // a 64 x 64 box: 64 n (or m) x 64 k
template <int BM, int BN, int STAGES>
struct WgCfg {
  static constexpr int A_BYTES = BM * WG_BK * 2;       // 16 KB at BM = 128
  static constexpr int B_BYTES = WG_BK * BN * 2;       // 32 KB at BN = 256
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int CONSUMERS = BM / 64 * 128;      // a consumer warpgroup per 64 rows
  static constexpr int NT = CONSUMERS + 128;           // + the producer warpgroup
  static constexpr int FRAG = BN / 2;                  // accumulators a consumer thread
  // the ring (1024-byte aligned for the 128-byte swizzle: 1 KB of slack)
  // and a full and an empty barrier per stage; kernels/mmad.py:
  // wgmma_geometry and core/schedule.py:ring_bytes mirror it
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
  // A 384-thread CTA launches with at most 168 registers a thread; only the
  // 128 x 256 tile's 128 accumulators need more, so only it moves
  // registers from the producer to the consumers (setmaxnreg 40 / 232).
  // Its ring also keeps it alone on its SM, which setmaxnreg needs.
  static constexpr bool MOVE_REGS = BM == 128 && BN == 256;
  static_assert(BM % 64 == 0 && BN % 64 == 0 && BN <= 256, "a wgmma tile");
  static_assert(SMEM <= 232448, "a CTA holds at most 227 KB of shared memory");
};

struct WgmmaArgs {
  void* C;
  int c_dt;
  int M, N, K;
};

// One 2-D TMA box, global -> shared, completing its bytes on the barrier.
// c0 is the coordinate along the map's contiguous dimension.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (all >> 4), layout type 1
// (128-byte swizzle) in bits 62-63. The tiles sit on 1024-byte boundaries,
// so the swizzle's base offset is 0.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define MMAD_WGMMA_M64N256K16(DT) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %130, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." DT "." DT " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63," \
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79," \
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95," \
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111," \
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, " \
      "%128, %129, p, 1, 1, %131, %132;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_A), "n"(TRANS_B))

#define MMAD_WGMMA_M64N64K16(DT) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." DT "." DT " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "%32, %33, p, 1, 1, %35, %36;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_A), "n"(TRANS_B))

#define MMAD_WGMMA_M64N128K16(DT) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." DT "." DT " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
      "%64, %65, p, 1, 1, %67, %68;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_A), "n"(TRANS_B))

// d (64 x N, fp32; N = 2 R) += A (64 x 16; M-major when TRANS_A, else
// K-major) * B (16 x N; N-major when TRANS_B, else K-major), both read from
// shared memory through descriptors.
template <typename T, int TRANS_A, int TRANS_B, int R>
__device__ __forceinline__ void wgmma_16bit(float (&d)[R], uint64_t da, uint64_t db) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (R == 128) {
    if constexpr (bf16) MMAD_WGMMA_M64N256K16("bf16"); else MMAD_WGMMA_M64N256K16("f16");
  } else if constexpr (R == 64) {
    if constexpr (bf16) MMAD_WGMMA_M64N128K16("bf16"); else MMAD_WGMMA_M64N128K16("f16");
  } else {
    static_assert(R == 32, "wgmma N of 64, 128 or 256");
    if constexpr (bf16) MMAD_WGMMA_M64N64K16("bf16"); else MMAD_WGMMA_M64N64K16("f16");
  }
}
#undef MMAD_WGMMA_M64N64K16
#undef MMAD_WGMMA_M64N128K16
#undef MMAD_WGMMA_M64N256K16

// Two adjacent outputs of a row, i and i + 1 (i even, so a pair is aligned
// when the row length is even), rounded once to c_dt.
__device__ __forceinline__ void store_pair(void* C, long long i, int c_dt, float v0, float v1) {
  if (c_dt == F32) {
    *reinterpret_cast<float2*>(static_cast<float*>(C) + i) = make_float2(v0, v1);
  } else if (c_dt == BF16) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(C) + i) =
        __floats2bfloat162_rn(v0, v1);
  } else {
    *reinterpret_cast<__half2*>(static_cast<__half*>(C) + i) = __floats2half2_rn(v0, v1);
  }
}

// A thread's accumulator d[4j + 2h + e] is C element (r0 + 8h, c0 + 8j + e)
// of the warpgroup's 64 x (R / 2) block (the wgmma D fragment: warp w holds
// rows 16w..16w+15, lane l row l / 4 and columns 2 (l % 4) + {0, 1} of every
// 8-column group). f(m, n, v0, v1) gets each in-range pair once.
template <int R, typename F>
__device__ __forceinline__ void for_each_pair(const float (&d)[R], int r0, int c0, int M,
                                              F f) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + 8 * h;
      if (m < M) f(m, c0 + 8 * j, d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    }
}

template <typename T, bool A_KMAJOR, bool B_KMAJOR, int BM, int BN, int STAGES>
__global__ void __launch_bounds__(WgCfg<BM, BN, STAGES>::NT, 1)
    mmad_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tb, const WgmmaArgs p) {
  using Cfg = WgCfg<BM, BN, STAGES>;
  extern __shared__ unsigned char wg_smem_raw[];
  unsigned char* smem = wg_smem_raw + ((1024 - (smem_u32(wg_smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * Cfg::STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nkb = (p.K + WG_BK - 1) / WG_BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], Cfg::CONSUMERS / 32);   // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {                                 // producer
    if constexpr (Cfg::MOVE_REGS) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      // N-contiguous B: boxes wholly past N are not loaded (they would
      // only feed columns the epilogue masks)
      const int boxes = B_KMAJOR ? 0 : min(BN / 64, (p.N - n0 + 63) / 64);
      const uint32_t bytes =
          B_KMAJOR ? Cfg::STAGE_BYTES : Cfg::A_BYTES + boxes * WG_BOX_BYTES;
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % STAGES;
        mbar_wait(&empty[s], ((kb / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], bytes);
        unsigned char* a_s = smem + s * Cfg::STAGE_BYTES;
        unsigned char* b_s = a_s + Cfg::A_BYTES;
        const int k0 = kb * WG_BK;
        if (A_KMAJOR) {
          tma_load_2d(a_s, &ta, k0, m0, &full[s]);
        } else {
          // every box, even past M: zero-filled, they only feed rows the
          // epilogue masks
          for (int j = 0; j < BM / 64; ++j)
            tma_load_2d(a_s + j * WG_BOX_BYTES, &ta, m0 + 64 * j, k0, &full[s]);
        }
        if (B_KMAJOR) {
          tma_load_2d(b_s, &tb, k0, n0, &full[s]);
        } else {
          for (int j = 0; j < boxes; ++j)
            tma_load_2d(b_s + j * WG_BOX_BYTES, &tb, n0 + 64 * j, k0, &full[s]);
        }
      }
    }
    return;
  }

  if constexpr (Cfg::MOVE_REGS) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int cw = wg - 1;                         // rows 64 cw.. of the tile
  const int lane = threadIdx.x & 31;
  float d[Cfg::FRAG];
#pragma unroll
  for (int i = 0; i < Cfg::FRAG; ++i) d[i] = 0.f;
  for (int kb = 0; kb < nkb; ++kb) {
    const int s = kb % STAGES;
    mbar_wait(&full[s], (kb / STAGES) & 1);
    // K-major A: 64 rows of 128 bytes per warpgroup; M-contiguous A: one
    // 64-row box per warpgroup
    const unsigned char* a_s =
        smem + s * Cfg::STAGE_BYTES + cw * (A_KMAJOR ? 64 * 128 : WG_BOX_BYTES);
    const unsigned char* b_s = smem + s * Cfg::STAGE_BYTES + Cfg::A_BYTES;
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      // K-major tiles: 128-byte rows, 8-row groups 1024 bytes apart; a
      // 16-deep K slice starts 32 bytes further along the (swizzled) row.
      // N-contiguous B: 64-column boxes 8 KB apart (leading offset), 8-k
      // groups 1024 bytes apart (stride offset); a K slice is 16 rows on.
      // An M-contiguous A is one such box (its 64 rows are one swizzle row).
      const uint64_t da = A_KMAJOR ? sw128_desc(a_s + kk * 32, 16, 1024)
                                   : sw128_desc(a_s + kk * 16 * 128, WG_BOX_BYTES, 1024);
      const uint64_t db = B_KMAJOR ? sw128_desc(b_s + kk * 32, 16, 1024)
                                   : sw128_desc(b_s + kk * 16 * 128, WG_BOX_BYTES, 1024);
      wgmma_16bit<T, A_KMAJOR ? 0 : 1, B_KMAJOR ? 0 : 1>(d, da, db);
    }
    wgmma_commit();
    fence_acc(d);
    // the previous stage's group has completed: its slot may be refilled
    wgmma_wait<1>();
    if (kb > 0 && lane == 0) mbar_arrive(&empty[(kb - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_acc(d);

  const int r0 = m0 + cw * 64 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  const int c0 = n0 + 2 * (lane & 3);
  const int N = p.N;
  const bool even = (N & 1) == 0;
  for_each_pair(d, r0, c0, p.M, [&](int m, int n, float v0, float v1) {
    const long long i = static_cast<long long>(m) * N + n;
    if (even && n + 1 < N) {
      store_pair(p.C, i, p.c_dt, v0, v1);
    } else {
      if (n < N) store_any(p.C, i, p.c_dt, v0);
      if (n + 1 < N) store_any(p.C, i + 1, p.c_dt, v1);
    }
  });
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query, so the library links nothing but the runtime.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A 2-D tensor map of bf16, fp16 or (as bytes) fp8 e4m3 elements with
// 128-byte swizzled boxes: d0 elements along the contiguous dimension, d1
// rows `stride` bytes apart. Boxes that cross an edge are zero-filled.
int tensor_map_2d(CUtensorMap* map, int dt, const void* base, long long d0, long long d1,
                  long long stride, int box0, int box1) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d0), static_cast<cuuint64_t>(d1)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box0), static_cast<cuuint32_t>(box1)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map,
      dt == BF16  ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
      : dt == F16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                  : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      2,
      const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Raises a kernel's dynamic shared-memory limit above the default 48 KB,
// once per device; `raised` is the kernel's own flags.
template <typename K>
int raise_smem(K kernel, int bytes, bool (&raised)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised[dev] = true;
  }
  return 0;
}

// grid: (M tiles, N tiles): consecutive CTAs share a column of B, so a
// wave reads a few N tiles of B against all of A (which L2 keeps). K is
// not split. A is K-contiguous when sak == 1, else M-contiguous; B is
// N-contiguous when sbn == 1, else K-contiguous. Refuses
// (cudaErrorInvalidValue) what kernels/mmad.py:wgmma_b_major and
// plan_launch would not send here, an M-contiguous A with a K-contiguous B
// among it; it never falls back.
template <typename T, int BM, int BN, int STAGES>
int launch_wgmma_inst(const StreamArgs& p, cudaStream_t stream) {
  using Cfg = WgCfg<BM, BN, STAGES>;
  const int dt = std::is_same<T, __nv_bfloat16>::value ? BF16 : F16;
  const long long lim = 1ll << 31;
  const bool a_kmajor = p.sak == 1;
  const bool b_nmajor = p.sbn == 1;
  const long long a_row = a_kmajor ? p.sam : p.sak;
  const long long b_row = b_nmajor ? p.sbk : p.sbn;
  const long long n_tiles = (p.N + BN - 1) / BN;
  if (p.a_dt != dt || (!a_kmajor && (p.sam != 1 || !b_nmajor)) || (!b_nmajor && p.sbk != 1) ||
      reinterpret_cast<uintptr_t>(p.A) % 16 || reinterpret_cast<uintptr_t>(p.B) % 16 ||
      (a_row * 2) % 16 || (b_row * 2) % 16 || p.M < 1 || p.N < 1 || p.K < 1 || p.M >= lim ||
      p.N >= lim || p.K >= lim || n_tiles > 65535 || p.splits != 1 ||
      (p.c_dt != F32 && p.c_dt != BF16 && p.c_dt != F16))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tb;
  int err = a_kmajor ? tensor_map_2d(&ta, dt, p.A, p.K, p.M, p.sam * 2, WG_BK, BM)
                     : tensor_map_2d(&ta, dt, p.A, p.M, p.K, p.sak * 2, 64, WG_BK);
  if (err) return err;
  err = b_nmajor ? tensor_map_2d(&tb, dt, p.B, p.N, p.K, p.sbk * 2, 64, WG_BK)
                 : tensor_map_2d(&tb, dt, p.B, p.K, p.N, p.sbn * 2, WG_BK, BN);
  if (err) return err;
  // the (A, B) majors: 0 = (K, N), 1 = (K, K), 2 = (MN, N)
  const int majors = a_kmajor ? (b_nmajor ? 0 : 1) : 2;
  auto kernel = majors == 0   ? mmad_wgmma_kernel<T, true, false, BM, BN, STAGES>
                : majors == 1 ? mmad_wgmma_kernel<T, true, true, BM, BN, STAGES>
                              : mmad_wgmma_kernel<T, false, false, BM, BN, STAGES>;
  static bool raised[3][64] = {};
  err = raise_smem(kernel, Cfg::SMEM, raised[majors]);
  if (err) return err;
  const WgmmaArgs args{p.C, p.c_dt, static_cast<int>(p.M), static_cast<int>(p.N),
                       static_cast<int>(p.K)};
  const dim3 grid(static_cast<unsigned>((p.M + BM - 1) / BM), static_cast<unsigned>(n_tiles));
  kernel<<<grid, Cfg::NT, Cfg::SMEM, stream>>>(ta, tb, args);
  return 0;
}

// The 16-bit instance `inst` (an index into TC_INSTANCES); refused when it
// names no 16-bit instance.
template <typename T, int I = 0>
int launch_wgmma(const StreamArgs& p, int inst, cudaStream_t stream) {
  if constexpr (I == N_TC_INSTANCES) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    constexpr TcInstance c = TC_INSTANCES[I];
    if constexpr (c.family == TC_16BIT) {
      static_assert(c.bk == WG_BK, "the 16-bit K step is one swizzle row");
      if (inst == I) return launch_wgmma_inst<T, c.bm, c.bn, c.stages>(p, stream);
    }
    return launch_wgmma<T, I + 1>(p, inst, stream);
  }
}

// ---------------------------------------------------------------------------
// fp8 e4m3 tensor-core kernel (wgmma.m64nBNk32.f32.e4m3.e4m3 fed by TMA)
// for both operands e4m3, A K-contiguous and B K- or N-contiguous, 16-byte
// aligned bases and row strides. fp8 wgmma reads only K-major operands from
// shared memory (the transpose bits are for 16-bit types), so an
// N-contiguous B, a (K, N) weight, is first transposed into a K-major copy
// in the workspace by a second kernel of the same call. A CTA computes an
// F8_BM x BN tile of C over its split's K range: warpgroup 0 is the
// producer, warpgroups 1 and 2 each own 64 rows. The tensor cores keep
// about 14 bits of the running sum of fp8 products (DeepSeek-V3, arXiv:
// 2412.19437, 3.3.2), so each consumer adds its tensor-core accumulator
// into fp32 registers on the CUDA cores every `promote` K steps
// ("promotion") and restarts it from zero.
// ---------------------------------------------------------------------------

constexpr int F8_BM = 128;
constexpr int F8_BK = 128;                             // one 128-byte swizzle row of e4m3
constexpr int F8_A_BYTES = F8_BM * F8_BK;              // 16 KB
constexpr int F8_CONSUMERS = 256;                      // two consumer warpgroups
constexpr int F8_NT = F8_CONSUMERS + 128;              // + the producer warpgroup
// The instances are TC_INSTANCES' TC_E4M3 rows, by the N width of a tile:
// 128, and 192, whose 40 KB stages feed 157 FLOP a byte of shared-memory
// fill, not 128 (on the card the 128-wide tile's large-M GEMMs stalled
// near 7 TB/s of fill). kernels/mmad.py:fp8_tile_width picks one by the
// waves its tiles take where the plan names none.
template <int BN, int STAGES>
struct F8Cfg {
  static constexpr int STAGE_BYTES = F8_A_BYTES + BN * F8_BK;
  // the ring, 1 KB of alignment slack, two barriers a stage
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
  static constexpr int TILE_FLOATS = F8_BM * BN;       // one split's fp32 partial tile
  static constexpr int FRAG = BN / 2;                  // accumulators a consumer thread
  static_assert(SMEM <= 232448, "a CTA holds at most 227 KB of shared memory");
};
constexpr int F8_T_K = 128, F8_T_N = 128;              // transpose tile, k x n bytes

struct Fp8Args {
  void* C;
  float* ws;          // fp32 partial tiles of a K split: (tiles, splits, F8_BM x BN)
  int* counters;      // one arrival counter per output tile; zero between launches
  int c_dt;
  int M, N, K;
  long long kps;      // k per split, whole F8_BK steps unless unsplit
  int promote;        // K steps between promotions; 0: once, at the end
  int stage_tx;       // bytes a stage's TMA loads bring (A's box, B's)
};

// d (64 x BN, fp32) = d * scale_d + A (64 x 32, K-major) * B (32 x BN,
// K-major), e4m3 operands read from shared memory through descriptors.
__device__ __forceinline__ void wgmma_e4m3(float (&d)[64], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e4m3 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_e4m3(float (&d)[96], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.f32.e4m3.e4m3 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The consumer warpgroups only (the producer has left).
__device__ __forceinline__ void fp8_consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(F8_CONSUMERS) : "memory");
}

// grid: (M tiles, N tiles, K splits). A thread of consumer warpgroup cw
// sums its 64 x BN block's fragment (BN / 2 fp32 a thread) into `sum`; a
// warpgroup whose rows all lie past M issues no wgmma. A split CTA writes
// its fp32 partial tile fragment by fragment (coalesced float4s), counts
// its arrival on the tile's counter, and the last of the tile's splits to
// arrive sums the partials in split order and writes C.
template <int BN, int STAGES>
__global__ void __launch_bounds__(F8_NT, 1)
    mmad_fp8_kernel(const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tb, const Fp8Args p) {
  using Cfg = F8Cfg<BN, STAGES>;
  constexpr int FRAG = Cfg::FRAG, Q = FRAG / 4;
  extern __shared__ unsigned char f8_smem_raw[];
  __shared__ int last;
  unsigned char* smem = f8_smem_raw + ((1024 - (smem_u32(f8_smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * Cfg::STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int m0 = blockIdx.x * F8_BM;
  const int n0 = blockIdx.y * BN;
  const long long kbeg = static_cast<long long>(blockIdx.z) * p.kps;
  const long long kend = (kbeg + p.kps < p.K) ? kbeg + p.kps : p.K;
  const int nkb = static_cast<int>((kend - kbeg + F8_BK - 1) / F8_BK);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], F8_CONSUMERS / 32);   // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {                                 // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % STAGES;
        mbar_wait(&empty[s], ((kb / STAGES) & 1) ^ 1);
        // whole boxes, even past M, N or K: zero-filled, and counted
        mbar_expect_tx(&full[s], p.stage_tx);
        unsigned char* a_s = smem + s * Cfg::STAGE_BYTES;
        const int k0 = static_cast<int>(kbeg) + kb * F8_BK;
        tma_load_2d(a_s, &ta, k0, m0, &full[s]);
        tma_load_2d(a_s + F8_A_BYTES, &tb, k0, n0, &full[s]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int cw = wg - 1;                         // rows 64 cw.. of the tile
  const int t = threadIdx.x & 127;
  const int lane = threadIdx.x & 31;
  const bool active = m0 + 64 * cw < p.M;
  float acc[FRAG], sum[FRAG];
#pragma unroll
  for (int i = 0; i < FRAG; ++i) acc[i] = sum[i] = 0.f;
  bool fresh = true;                             // acc holds nothing yet
  for (int kb = 0; kb < nkb; ++kb) {
    const int s = kb % STAGES;
    mbar_wait(&full[s], (kb / STAGES) & 1);
    if (active) {
      // K-major tiles: 128-byte rows, 8-row groups 1024 bytes apart; a
      // 32-deep K slice starts 32 bytes further along the (swizzled) row
      const unsigned char* a_s = smem + s * Cfg::STAGE_BYTES + cw * 64 * F8_BK;
      const unsigned char* b_s = smem + s * Cfg::STAGE_BYTES + F8_A_BYTES;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < F8_BK / 32; ++kk)
        wgmma_e4m3(acc, sw128_desc(a_s + kk * 32, 16, 1024), sw128_desc(b_s + kk * 32, 16, 1024),
                   kk > 0 || !fresh);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);       // the stage's slot may be refilled
    fresh = kb + 1 == nkb || (p.promote > 0 && (kb + 1) % p.promote == 0);
    if (fresh) {
#pragma unroll
      for (int i = 0; i < FRAG; ++i) sum[i] += acc[i];
    }
  }

  const int r0 = m0 + cw * 64 + (t >> 5) * 16 + (lane >> 2);
  const int c0 = n0 + 2 * (lane & 3);
  const int N = p.N;
  const bool even = (N & 1) == 0;
  auto store = [&](const float (&v)[FRAG]) {
    for_each_pair(v, r0, c0, p.M, [&](int m, int n, float v0, float v1) {
      const long long i = static_cast<long long>(m) * N + n;
      if (even && n + 1 < N) {
        store_pair(p.C, i, p.c_dt, v0, v1);
      } else {
        if (n < N) store_any(p.C, i, p.c_dt, v0);
        if (n + 1 < N) store_any(p.C, i + 1, p.c_dt, v1);
      }
    });
  };
  const int splits = static_cast<int>(gridDim.z);
  if (splits == 1) {
    if (active) store(sum);
    return;
  }
  // the split's partial: its warpgroup's fragments, float4 q of thread t at
  // (q * 128 + t), so a warp's stores are contiguous
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  auto part = [&](int z) {
    return reinterpret_cast<float4*>(p.ws) +
           (static_cast<long long>(tile) * splits + z) * (Cfg::TILE_FLOATS / 4) + cw * Q * 128 + t;
  };
  if (active) {
    float4* out = part(blockIdx.z);
#pragma unroll
    for (int q = 0; q < Q; ++q)
      __stcg(out + q * 128, make_float4(sum[4 * q], sum[4 * q + 1], sum[4 * q + 2], sum[4 * q + 3]));
  }
  fp8_consumer_sync();                           // the CTA's partial is written
  if (threadIdx.x == 128) last = arrive_last(&p.counters[tile], splits);
  fp8_consumer_sync();
  if (!last || !active) return;
#pragma unroll
  for (int i = 0; i < FRAG; ++i) sum[i] = 0.f;
  for (int z = 0; z < splits; ++z) {             // split order: bitwise repeatable
    const float4* in = part(z);
    float4 v[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) v[q] = __ldcg(in + q * 128);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      sum[4 * q] += v[q].x;
      sum[4 * q + 1] += v[q].y;
      sum[4 * q + 2] += v[q].z;
      sum[4 * q + 3] += v[q].w;
    }
  }
  store(sum);
}

// B (K, N) e4m3, N-contiguous rows `sbk` bytes apart -> Bt (N, ldt),
// K-contiguous, a F8_T_K x F8_T_N tile a CTA. A thread loads 4 x 4-byte
// blocks (4 k rows of 4 n bytes; a warp reads 128 bytes of each row) and
// transposes each in registers (__byte_perm) into 4 words of 4 k bytes,
// one a column, into a word-pitched shared tile; then each thread writes
// 16 k bytes of a column, a warp 128 bytes of each of 4 rows. Both sides
// move whole 128-byte lines. k from K to ldt (a row's 16-byte padding) is
// written as zeros.
__global__ void __launch_bounds__(256)
    mmad_fp8_transpose_kernel(const uint8_t* B, uint8_t* Bt, int K, int N, long long sbk,
                              int ldt) {
  __shared__ uint32_t tile[F8_T_N][F8_T_K / 4 + 1];     // [n][k / 4]
  const long long k0 = static_cast<long long>(blockIdx.y) * F8_T_K;
  const long long n0 = static_cast<long long>(blockIdx.x) * F8_T_N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n = n0 + 4 * lane;
#pragma unroll
  for (int u = 0; u < F8_T_K / 32; ++u) {
    const int bk = warp + 8 * u;                 // k rows 4 bk .. 4 bk + 3
    uint32_t x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long k = k0 + 4 * bk + i;
      x[i] = 0;
      if (k < K && n < N) {
        const uint8_t* src = B + k * sbk + n;
        if (n + 4 <= N) {
          x[i] = __ldg(reinterpret_cast<const uint32_t*>(src));
        } else {
          for (int j = 0; j < 4; ++j)
            if (n + j < N) x[i] |= static_cast<uint32_t>(src[j]) << (8 * j);
        }
      }
    }
    // x[i] byte j is (k 4 bk + i, n + j): column j's 4 k bytes
    const uint32_t t0 = __byte_perm(x[0], x[1], 0x5140), t1 = __byte_perm(x[2], x[3], 0x5140);
    const uint32_t t2 = __byte_perm(x[0], x[1], 0x7362), t3 = __byte_perm(x[2], x[3], 0x7362);
    tile[4 * lane][bk] = __byte_perm(t0, t1, 0x5410);
    tile[4 * lane + 1][bk] = __byte_perm(t0, t1, 0x7632);
    tile[4 * lane + 2][bk] = __byte_perm(t2, t3, 0x5410);
    tile[4 * lane + 3][bk] = __byte_perm(t2, t3, 0x7632);
  }
  __syncthreads();
  const int c = threadIdx.x % 8;                 // k bytes 16 c .. 16 c + 15
  const long long k = k0 + 16 * c;
#pragma unroll
  for (int u = 0; u < F8_T_N / 32; ++u) {
    const int r = threadIdx.x / 8 + 32 * u;
    if (n0 + r < N && k < ldt)
      *reinterpret_cast<uint4*>(Bt + (n0 + r) * ldt + k) =
          make_uint4(tile[r][4 * c], tile[r][4 * c + 1], tile[r][4 * c + 2], tile[r][4 * c + 3]);
  }
}

// Float offset of the transposed B in the workspace, after the partials,
// on a 256-byte boundary; kernels/mmad.py:fp8_geometry mirrors it.
long long fp8_bt_offset(long long tiles, int splits, int tile_floats) {
  const long long part = splits > 1 ? tiles * splits * tile_floats : 0;
  return (part + 63) / 64 * 64;
}

// grid: (M tiles, N tiles, K splits), as the bf16 kernel's: consecutive
// CTAs share a column of B. A is K-contiguous (sak == 1); B N-contiguous
// when sbn == 1 (transposed first into the workspace), else K-contiguous
// (sbk == 1). Refuses (cudaErrorInvalidValue) what kernels/mmad.py:
// wgmma_b_major and fp8_geometry would not send here; it never falls back.
template <int BN, int STAGES>
int launch_fp8_inst(const StreamArgs& p, bool b_nmajor, int promote, cudaStream_t stream) {
  using Cfg = F8Cfg<BN, STAGES>;
  const long long m_tiles = (p.M + F8_BM - 1) / F8_BM;
  const long long n_tiles = (p.N + BN - 1) / BN;
  if (n_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // A's box: 64 rows where M fits them (warpgroup 2 then idles, and the
  // TMA fills no rows past M), else the tile's F8_BM
  const int a_rows = p.M <= 64 ? 64 : F8_BM;
  CUtensorMap ta, tb;
  int err = tensor_map_2d(&ta, F8E4M3, p.A, p.K, p.M, p.sam, F8_BK, a_rows);
  if (err) return err;
  if (b_nmajor) {
    const int ldt = static_cast<int>((p.K + 15) / 16 * 16);
    uint8_t* bt = reinterpret_cast<uint8_t*>(
        p.ws + fp8_bt_offset(m_tiles * n_tiles, p.splits, Cfg::TILE_FLOATS));
    const dim3 tgrid(static_cast<unsigned>((p.N + F8_T_N - 1) / F8_T_N),
                     static_cast<unsigned>((p.K + F8_T_K - 1) / F8_T_K));
    mmad_fp8_transpose_kernel<<<tgrid, 256, 0, stream>>>(static_cast<const uint8_t*>(p.B), bt,
                                                         static_cast<int>(p.K),
                                                         static_cast<int>(p.N), p.sbk, ldt);
    const cudaError_t terr = cudaGetLastError();
    if (terr != cudaSuccess) return static_cast<int>(terr);
    err = tensor_map_2d(&tb, F8E4M3, bt, p.K, p.N, ldt, F8_BK, BN);
  } else {
    err = tensor_map_2d(&tb, F8E4M3, p.B, p.K, p.N, p.sbn, F8_BK, BN);
  }
  if (err) return err;
  static bool raised[64] = {};
  err = raise_smem(mmad_fp8_kernel<BN, STAGES>, Cfg::SMEM, raised);
  if (err) return err;
  const Fp8Args args{p.C,
                     p.ws,
                     static_cast<int*>(p.counters),
                     p.c_dt,
                     static_cast<int>(p.M),
                     static_cast<int>(p.N),
                     static_cast<int>(p.K),
                     p.kps,
                     promote,
                     (a_rows + BN) * F8_BK};
  const dim3 grid(static_cast<unsigned>(m_tiles), static_cast<unsigned>(n_tiles), p.splits);
  mmad_fp8_kernel<BN, STAGES><<<grid, F8_NT, Cfg::SMEM, stream>>>(ta, tb, args);
  return 0;
}

// The e4m3 instance `inst` (an index into TC_INSTANCES); refused when it
// names no e4m3 instance.
template <int I = 0>
int launch_fp8_at(const StreamArgs& p, bool b_nmajor, int inst, int promote,
                  cudaStream_t stream) {
  if constexpr (I == N_TC_INSTANCES) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    constexpr TcInstance c = TC_INSTANCES[I];
    if constexpr (c.family == TC_E4M3) {
      static_assert(c.bm == F8_BM && c.bk == F8_BK, "the fp8 tile is 128 rows, 128 k a step");
      if (inst == I) return launch_fp8_inst<c.bn, c.stages>(p, b_nmajor, promote, stream);
    }
    return launch_fp8_at<I + 1>(p, b_nmajor, inst, promote, stream);
  }
}

// `sub` is the instance's index in TC_INSTANCES x 256 + the K steps between
// promotions, as kernels/mmad.py:plan_launch and FP8_PROMOTE_STEPS give
// them.
int launch_fp8(const StreamArgs& p, int b_dt, int sub, cudaStream_t stream) {
  const int inst = sub >> 8, promote = sub & 255;
  const long long lim = 1ll << 31;
  const bool b_nmajor = p.sbn == 1;
  const bool split_ok =
      p.splits == 1 ? p.kps >= p.K
                    : (p.splits > 1 && p.splits <= 65535 && p.ws != nullptr &&
                       p.counters != nullptr && p.kps % F8_BK == 0 &&
                       (p.splits - 1) * p.kps < p.K && p.splits * p.kps >= p.K);
  if (p.a_dt != F8E4M3 || b_dt != F8E4M3 || p.sak != 1 || p.sam % 16 || p.sam < p.K ||
      (b_nmajor ? (p.sbk % 16 || p.sbk < p.N) : (p.sbk != 1 || p.sbn % 16 || p.sbn < p.K)) ||
      reinterpret_cast<uintptr_t>(p.A) % 16 || reinterpret_cast<uintptr_t>(p.B) % 16 ||
      p.M < 1 || p.N < 1 || p.K < 1 || p.M >= lim || p.N >= lim || p.K >= lim ||
      !split_ok ||
      (b_nmajor && (p.ws == nullptr || (p.K + F8_T_K - 1) / F8_T_K > 65535)) ||
      (p.c_dt != F32 && p.c_dt != BF16 && p.c_dt != F16))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_fp8_at(p, b_nmajor, inst, promote, stream);
}

// ---------------------------------------------------------------------------
// SIMT tile route: what neither the stream kernels nor the tensor cores take
// (fp32, fp8 e4m3 and int8 operands, mixed dtypes, strides no tensor map
// describes), summed in IEEE fp32 FMAs on the CUDA cores. A CTA of
// TILE_NT threads computes a BM x BN tile of C over its split's K range in
// TILE_BK-deep stages; its threads form KS K slices, each slice summing
// its BK / KS k of every stage into a TM x TN register block per thread,
// and the slices meet in shared memory at the end. A K split is fixed up
// in the same launch (arrive_last, as the stream kernels do).
// ---------------------------------------------------------------------------

constexpr int TILE_NT = 256;
constexpr int TILE_BK = 32;

// Instance codes and shapes, mirrored by kernels/mmad.py:TILE_CONFIGS.
// min_ctas is what __launch_bounds__ asks an SM to keep resident (it caps
// the registers: one CTA lets the 8 x 8 instances use up to 255, no spills)
// and the slots kernels/mmad.py:_balanced_splits fills.
enum TileInst : int { T_GENERIC = 0, T_NARROW8, T_NARROW16, T_NARROW32, T_NARROW64, T_WIDE };
struct TileCfg {
  int bm, bn, tm, tn, ks, stages, min_ctas;
};
constexpr TileCfg TILE_CFGS[] = {
    // bm   bn  tm  tn  ks stages min_ctas
    {64, 64, 4, 4, 1, 2, 2},      // generic: scalar loads, runtime dtypes, any strides
    {64, 8, 1, 8, 4, 4, 2},       // narrow: N <= 8
    {64, 16, 2, 8, 4, 4, 2},      // narrow: N <= 16
    {64, 32, 4, 8, 4, 4, 2},      // narrow: N <= 32
    {64, 64, 8, 8, 4, 4, 1},      // narrow: N <= 64
    {128, 128, 8, 8, 1, 3, 1},    // wide
};

struct TileArgs {
  const void* A;
  const void* B;
  void* C;
  float* ws;          // fp32 partials of a K split: (tiles, splits, BM, BN)
  int* counters;      // one arrival counter per output tile; zero between launches
  int a_dt, b_dt, c_dt;
  long long M, N, K, sam, sak, sbk, sbn;
  long long kps;      // k per split, a whole number of TILE_BK unless unsplit
  int splits;
};

// Shared-memory layout of one instance: a ring of stages, each an A tile
// (BM rows of TILE_BK k, row-major, rows one 16-byte bank group apart) and
// a B tile (TILE_BK rows of BN n); after the loop the same memory holds the
// slices' fp32 sums, KS x BM rows of BN (+ 4) columns.
template <int INST, typename SA, typename SB>
struct TileSmem {
  static constexpr TileCfg C = TILE_CFGS[INST];
  static constexpr int A_PITCH = TILE_BK * static_cast<int>(sizeof(SA)) + 16;
  static constexpr int B_PITCH = C.bn * static_cast<int>(sizeof(SB));
  static constexpr int A_BYTES = C.bm * A_PITCH;
  static constexpr int STAGE_BYTES = A_BYTES + TILE_BK * B_PITCH;
  static constexpr int R_PITCH = C.bn + 4;                      // floats
  static constexpr int RING = C.stages * STAGE_BYTES;
  static constexpr int RED = C.ks * C.bm * R_PITCH * 4;
  static constexpr int BYTES = RING > RED ? RING : RED;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Four consecutive elements of shared memory as fp32, exactly.
template <typename T>
__device__ __forceinline__ void ld4(const unsigned char* p, float* o);
template <>
__device__ __forceinline__ void ld4<float>(const unsigned char* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
template <>
__device__ __forceinline__ void ld4<__nv_bfloat16>(const unsigned char* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(v.x << 16);
  o[1] = __uint_as_float(v.x & 0xffff0000u);
  o[2] = __uint_as_float(v.y << 16);
  o[3] = __uint_as_float(v.y & 0xffff0000u);
}
template <>
__device__ __forceinline__ void ld4<__half>(const unsigned char* p, float* o) {
  const __half2* h = reinterpret_cast<const __half2*>(p);
  const float2 lo = __half22float2(h[0]);
  const float2 hi = __half22float2(h[1]);
  o[0] = lo.x;
  o[1] = lo.y;
  o[2] = hi.x;
  o[3] = hi.y;
}
template <>
__device__ __forceinline__ void ld4<__nv_fp8_e4m3>(const unsigned char* p, float* o) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int h = 0; h < 2; ++h) {    // e4m3 -> fp16 is exact
    const __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>((v >> (16 * h)) & 0xffffu), __NV_E4M3);
    const float2 f = __half22float2(__half2(r));
    o[2 * h] = f.x;
    o[2 * h + 1] = f.y;
  }
}
template <>
__device__ __forceinline__ void ld4<int8_t>(const unsigned char* p, float* o) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] = static_cast<float>(static_cast<int8_t>(v >> (8 * e)));
}

__device__ __forceinline__ void add4(float4& s, const float4& x) {
  s.x += x.x;
  s.y += x.y;
  s.z += x.z;
  s.w += x.w;
}

// Row m, columns n..n+3 of C, each rounded once to c_dt; columns past N are
// dropped, rows past M too.
__device__ __forceinline__ void store_quad(const TileArgs& p, long long m, long long n,
                                           const float4& v) {
  if (m >= p.M) return;
  const long long i = m * p.N + n;
  if ((p.N & 3) == 0 && n + 3 < p.N) {          // 4-aligned within an aligned C
    if (p.c_dt == F32) {
      *reinterpret_cast<float4*>(static_cast<float*>(p.C) + i) = v;
    } else {
      store_pair(p.C, i, p.c_dt, v.x, v.y);
      store_pair(p.C, i + 2, p.c_dt, v.z, v.w);
    }
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (n + j < p.N) store_any(p.C, i + j, p.c_dt, e[j]);
}

// A thread's share of an R x C tile: element i sits at (r0 + i*dr, c0 + i*dc).
// Threads run fastest along the operand's contiguous dim, so a warp reads
// consecutive addresses (the generic instance's scalar loads).
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

// One CTA: the BM x BN tile (blockIdx.y, blockIdx.x) of C over K range
// [z kps, min((z + 1) kps, K)), z = blockIdx.z. Vector instances (SA, SB
// the operands' own one dtype; A K-contiguous and B N-contiguous, 16-byte
// aligned rows) copy each stage into the ring with 16-byte cp.async,
// STAGES - 1 stages in flight while one is summed, one barrier a stage;
// ragged edges are zero-filled by the copies' source sizes. The generic
// instance (SA = SB = float) loads scalars of any dtype and stride into
// registers while the current stage is summed and stores them as fp32
// after. Thread (slice, ty, tx) owns rows ty + i*RY (i < TM) and the
// 4-column groups tx + j*TX (j < TN/4) of the tile.
template <int INST, typename SA, typename SB>
__global__ void __launch_bounds__(TILE_NT, TILE_CFGS[INST].min_ctas)
    mmad_tile_kernel(const TileArgs p) {
  using L = TileSmem<INST, SA, SB>;
  constexpr TileCfg C = TILE_CFGS[INST];
  constexpr int BM = C.bm, BN = C.bn, TM = C.tm, TN = C.tn, KS = C.ks, STAGES = C.stages;
  constexpr int BK = TILE_BK;
  constexpr int TX = BN / TN, RY = BM / TM, TPS = TX * RY;    // threads per K slice
  constexpr int BKS = BK / KS;                                 // k per slice per stage
  constexpr bool GENERIC = INST == T_GENERIC;
  static_assert(TPS * KS == TILE_NT && BKS % 4 == 0 && TN % 4 == 0, "tile shape");
  static_assert(!GENERIC || (std::is_same<SA, float>::value && std::is_same<SB, float>::value),
                "the generic instance stages fp32");
  extern __shared__ __align__(16) unsigned char tile_smem[];
  __shared__ int last;

  const int tid = threadIdx.x;
  const int slice = tid / TPS, ts = tid % TPS, tx = ts % TX, ty = ts / TX;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const long long n0 = static_cast<long long>(blockIdx.x) * BN;
  const long long kbeg = static_cast<long long>(blockIdx.z) * p.kps;
  const long long kend = (kbeg + p.kps < p.K) ? kbeg + p.kps : p.K;
  const int nk = kbeg < kend ? static_cast<int>((kend - kbeg + BK - 1) / BK) : 0;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // sums stage `it` of this slice's k into the register block
  auto compute = [&](int it) {
    const unsigned char* st = tile_smem + (it % STAGES) * L::STAGE_BYTES;
    const unsigned char* as = st + ty * L::A_PITCH + slice * BKS * sizeof(SA);
    const unsigned char* bs =
        st + L::A_BYTES + slice * BKS * L::B_PITCH + tx * 4 * sizeof(SB);
#pragma unroll
    for (int kq = 0; kq < BKS; kq += 4) {
      float a[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) ld4<SA>(as + i * RY * L::A_PITCH + kq * sizeof(SA), a[i]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[TN];
#pragma unroll
        for (int j = 0; j < TN / 4; ++j)
          ld4<SB>(bs + (kq + kk) * L::B_PITCH + j * TX * 4 * sizeof(SB), b + 4 * j);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
      }
    }
  };

  if constexpr (!GENERIC) {
    constexpr int VA = 16 / sizeof(SA), CPA = BK / VA;          // 16-byte chunks per A row
    constexpr int VB = 16 / sizeof(SB), CPB = BN / VB;          // and per B row
    static_assert(CPB >= 1, "a B row of the tile is at least 16 bytes");
    const SA* A = static_cast<const SA*>(p.A);
    const SB* B = static_cast<const SB*>(p.B);
    // stage it's copies into its slot; a chunk past an edge copies 0..15
    // bytes and zero-fills the rest
    auto issue = [&](int it) {
      unsigned char* st = tile_smem + (it % STAGES) * L::STAGE_BYTES;
      const long long k0 = kbeg + static_cast<long long>(it) * BK;
#pragma unroll
      for (int u = 0; u < (BM * CPA + TILE_NT - 1) / TILE_NT; ++u) {
        const int c = tid + u * TILE_NT;
        if ((BM * CPA) % TILE_NT == 0 || c < BM * CPA) {
          const int r = c / CPA, ch = c % CPA;
          const long long m = m0 + r, k = k0 + ch * VA;
          const long long left = kend - k;
          const int valid = (m < p.M && left > 0) ? static_cast<int>(left < VA ? left : VA) : 0;
          cp_async16(st + r * L::A_PITCH + ch * 16, valid ? A + m * p.sam + k : A,
                     valid * static_cast<int>(sizeof(SA)));
        }
      }
#pragma unroll
      for (int u = 0; u < (BK * CPB + TILE_NT - 1) / TILE_NT; ++u) {
        const int c = tid + u * TILE_NT;
        if ((BK * CPB) % TILE_NT == 0 || c < BK * CPB) {
          const int r = c / CPB, ch = c % CPB;
          const long long k = k0 + r, n = n0 + ch * VB;
          const long long left = p.N - n;
          const int valid = (k < kend && left > 0) ? static_cast<int>(left < VB ? left : VB) : 0;
          cp_async16(st + L::A_BYTES + r * L::B_PITCH + ch * 16, valid ? B + k * p.sbk + n : B,
                     valid * static_cast<int>(sizeof(SB)));
        }
      }
    };
#pragma unroll 1
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) issue(s);
      cp_async_commit();
    }
#pragma unroll 1
    for (int it = 0; it < nk; ++it) {
      cp_async_wait<STAGES - 2>();       // this thread's copies of stage it landed
      __syncthreads();                   // everyone's; and stage it - 1 is summed
      if (it + STAGES - 1 < nk) issue(it + STAGES - 1);   // into stage it - 1's slot
      cp_async_commit();
      compute(it);
    }
    cp_async_wait<0>();
  } else {
    constexpr int A_PT = BM * BK / TILE_NT, B_PT = BK * BN / TILE_NT;
    static_assert(STAGES == 2, "the generic instance double-buffers");
    const TileWalk wa(tid, BM, BK, TILE_NT, p.sak == 1 && p.sam != 1);
    const TileWalk wb(tid, BK, BN, TILE_NT, !(p.sbk == 1 && p.sbn != 1));
    const long long a_base = (m0 + wa.r0) * p.sam + wa.c0 * p.sak;
    const long long a_step = wa.dr * p.sam + wa.dc * p.sak;
    const long long b_base = wb.r0 * p.sbk + (n0 + wb.c0) * p.sbn;
    const long long b_step = wb.dr * p.sbk + wb.dc * p.sbn;
    float ra[A_PT], rb[B_PT];
    auto fetch = [&](int it) {
      const long long k0 = kbeg + static_cast<long long>(it) * BK;
#pragma unroll
      for (int i = 0; i < A_PT; ++i) {
        const bool ok = m0 + wa.r0 + i * wa.dr < p.M && k0 + wa.c0 + i * wa.dc < kend;
        ra[i] = ok ? load_any(p.A, a_base + k0 * p.sak + i * a_step, p.a_dt) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < B_PT; ++i) {
        const bool ok = k0 + wb.r0 + i * wb.dr < kend && n0 + wb.c0 + i * wb.dc < p.N;
        rb[i] = ok ? load_any(p.B, b_base + k0 * p.sbk + i * b_step, p.b_dt) : 0.f;
      }
    };
    auto deposit = [&](int it) {
      unsigned char* st = tile_smem + (it % STAGES) * L::STAGE_BYTES;
      float* as = reinterpret_cast<float*>(st);
      float* bs = reinterpret_cast<float*>(st + L::A_BYTES);
#pragma unroll
      for (int i = 0; i < A_PT; ++i)
        as[(wa.r0 + i * wa.dr) * (L::A_PITCH / 4) + wa.c0 + i * wa.dc] = ra[i];
#pragma unroll
      for (int i = 0; i < B_PT; ++i) bs[(wb.r0 + i * wb.dr) * BN + wb.c0 + i * wb.dc] = rb[i];
    };
    if (nk > 0) {
      fetch(0);
      deposit(0);
    }
#pragma unroll 1
    for (int it = 0; it < nk; ++it) {
      __syncthreads();                   // stage it stored; stage it - 1 summed
      const bool more = it + 1 < nk;
      if (more) fetch(it + 1);           // its loads fly while stage it is summed
      compute(it);
      if (more) deposit(it + 1);         // into stage it - 1's slot
    }
  }
  __syncthreads();                       // the ring is free for the slices' sums

  float* red = reinterpret_cast<float*>(tile_smem);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN / 4; ++j)
      *reinterpret_cast<float4*>(red + (slice * BM + ty + i * RY) * L::R_PITCH + tx * 4 +
                                 j * TX * 4) =
          make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2], acc[i][4 * j + 3]);
  __syncthreads();

  // the tile in 4-column quads, QPT a thread: the slices' sums in slice order
  constexpr int QPR = BN / 4, QUADS = BM * QPR, QPT = (QUADS + TILE_NT - 1) / TILE_NT;
  float4 v[QPT];
#pragma unroll
  for (int q = 0; q < QPT; ++q) {
    const int idx = tid + q * TILE_NT;
    v[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (QUADS % TILE_NT == 0 || idx < QUADS) {
      const int r = idx / QPR, c = (idx % QPR) * 4;
      v[q] = *reinterpret_cast<const float4*>(red + r * L::R_PITCH + c);
#pragma unroll
      for (int s = 1; s < KS; ++s)
        add4(v[q], *reinterpret_cast<const float4*>(red + (s * BM + r) * L::R_PITCH + c));
    }
  }
  auto in_tile = [&](int q) { return QUADS % TILE_NT == 0 || tid + q * TILE_NT < QUADS; };
  auto row_of = [&](int q) { return m0 + (tid + q * TILE_NT) / QPR; };
  auto col_of = [&](int q) { return n0 + ((tid + q * TILE_NT) % QPR) * 4; };

  const int splits = static_cast<int>(gridDim.z);
  if (splits == 1) {
#pragma unroll
    for (int q = 0; q < QPT; ++q)
      if (in_tile(q)) store_quad(p, row_of(q), col_of(q), v[q]);
    return;
  }
  // the tile's partials, (splits, BM, BN) fp32, a whole tile each
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  float* part = p.ws + static_cast<long long>(tile) * splits * (BM * BN);
#pragma unroll
  for (int q = 0; q < QPT; ++q)
    if (in_tile(q))
      __stcg(reinterpret_cast<float4*>(part + static_cast<long long>(blockIdx.z) * (BM * BN)) +
                 tid + q * TILE_NT,
             v[q]);
  __syncthreads();                       // the CTA's partial is written
  if (tid == 0) last = arrive_last(&p.counters[tile], splits);
  __syncthreads();
  if (!last) return;
  // the last split to arrive sums every split's partial in split order,
  // ZB splits' loads in flight before any is added
  constexpr int ZB = QPT >= 16 ? 1 : 16 / QPT;
#pragma unroll
  for (int q = 0; q < QPT; ++q) v[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int z0 = 0; z0 < splits; z0 += ZB) {
    float4 t[ZB][QPT];
#pragma unroll
    for (int zz = 0; zz < ZB; ++zz)
#pragma unroll
      for (int q = 0; q < QPT; ++q)
        t[zz][q] = (z0 + zz < splits && in_tile(q))
                       ? __ldcg(reinterpret_cast<const float4*>(
                                    part + static_cast<long long>(z0 + zz) * (BM * BN)) +
                                tid + q * TILE_NT)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int zz = 0; zz < ZB; ++zz)
#pragma unroll
      for (int q = 0; q < QPT; ++q)
        if (z0 + zz < splits) add4(v[q], t[zz][q]);
  }
#pragma unroll
  for (int q = 0; q < QPT; ++q)
    if (in_tile(q)) store_quad(p, row_of(q), col_of(q), v[q]);
}

int elem_bytes(int dt) { return dt == F32 ? 4 : (dt == BF16 || dt == F16) ? 2 : 1; }

template <int INST, typename SA, typename SB>
int launch_tile_inst(const TileArgs& p, cudaStream_t stream) {
  constexpr TileCfg C = TILE_CFGS[INST];
  const long long gx = (p.N + C.bn - 1) / C.bn, gy = (p.M + C.bm - 1) / C.bm;
  if (gx > 0x7fffffffll || gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = TileSmem<INST, SA, SB>::BYTES;
  // above the default 48 KB: raise the instance's limit once per device
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(mmad_tile_kernel<INST, SA, SB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised[dev] = true;
  }
  mmad_tile_kernel<INST, SA, SB>
      <<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy), p.splits), TILE_NT, smem,
         stream>>>(p);
  return 0;
}

template <typename T>
int launch_tile_vec(const TileArgs& p, int inst, cudaStream_t stream) {
  switch (inst) {
    case T_NARROW8:
      if constexpr (sizeof(T) >= 2) return launch_tile_inst<T_NARROW8, T, T>(p, stream);
      break;
    case T_NARROW16: return launch_tile_inst<T_NARROW16, T, T>(p, stream);
    case T_NARROW32: return launch_tile_inst<T_NARROW32, T, T>(p, stream);
    case T_NARROW64: return launch_tile_inst<T_NARROW64, T, T>(p, stream);
    case T_WIDE: return launch_tile_inst<T_WIDE, T, T>(p, stream);
    default: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tile route's launch, `inst` as kernels/mmad.py:tile_geometry picks it.
// Refuses (cudaErrorInvalidValue) what that function would not send to the
// instance: a vector instance takes one dtype, A K-contiguous and B
// N-contiguous with 16-byte aligned bases and rows; a split needs the
// scratch, whole TILE_BK blocks per split and no empty split. It never
// falls back to another instance.
int launch_tile(const TileArgs& p, int inst, cudaStream_t stream) {
  const bool split_ok =
      p.splits == 1 ||
      (p.splits > 1 && p.splits <= 65535 && p.ws != nullptr && p.counters != nullptr &&
       p.kps % TILE_BK == 0 && (p.splits - 1) * p.kps < p.K);
  if (p.M < 1 || p.N < 1 || p.K < 0 || p.kps < 1 || p.splits * p.kps < p.K || !split_ok ||
      (p.c_dt != F32 && p.c_dt != BF16 && p.c_dt != F16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (inst == T_GENERIC) return launch_tile_inst<T_GENERIC, float, float>(p, stream);
  const long long eb = elem_bytes(p.a_dt);
  if (p.a_dt != p.b_dt || p.sak != 1 || p.sbn != 1 || reinterpret_cast<uintptr_t>(p.A) % 16 ||
      reinterpret_cast<uintptr_t>(p.B) % 16 || (p.sam * eb) % 16 || (p.sbk * eb) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (p.a_dt) {
    case F32: return launch_tile_vec<float>(p, inst, stream);
    case BF16: return launch_tile_vec<__nv_bfloat16>(p, inst, stream);
    case F16: return launch_tile_vec<__half>(p, inst, stream);
    case F8E4M3: return launch_tile_vec<__nv_fp8_e4m3>(p, inst, stream);
    case I8: return launch_tile_vec<int8_t>(p, inst, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The compiled tensor-core instances, `cap` at most, as five ints each
// (family, bm, bn, bk, stages) in TC_INSTANCES' order; returns how many
// there are. kernels/mmad.py holds them to its mirror when it loads the
// library.
extern "C" int mmad_instances(int* out, int cap) {
  for (int i = 0; i < N_TC_INSTANCES && i < cap; ++i) {
    const TcInstance& c = TC_INSTANCES[i];
    const int row[5] = {c.family, c.bm, c.bn, c.bk, c.stages};
    for (int j = 0; j < 5; ++j) out[5 * i + j] = row[j];
  }
  return N_TC_INSTANCES;
}

extern "C" int mmad_launch(const void* a, const void* b, void* c, void* ws, void* counters,
                           int a_dt, int b_dt, int c_dt, long long M, long long N, long long K,
                           long long sam, long long sak, long long sbk, long long sbn,
                           long long kps, int splits, int variant, int sub,
                           void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int err;
  if (variant == 0) {
    const TileArgs p{a,   b,   c,   static_cast<float*>(ws), static_cast<int*>(counters),
                     a_dt, b_dt, c_dt, M, N, K, sam, sak, sbk, sbn, kps, splits};
    err = launch_tile(p, sub, stream);
    return err ? err : static_cast<int>(cudaGetLastError());
  }
  const StreamArgs p{a, b, c, static_cast<float*>(ws), static_cast<int*>(counters), a_dt, c_dt,
                     M, N, K, sam, sak, sbk, sbn, kps, splits};
  if (variant == 3) {
    if (b_dt == BF16) {
      err = launch_wgmma<__nv_bfloat16>(p, sub, stream);
    } else if (b_dt == F16) {
      err = launch_wgmma<__half>(p, sub, stream);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return err ? err : static_cast<int>(cudaGetLastError());
  }
  if (variant == 4) {
    err = launch_fp8(p, b_dt, sub, stream);
    return err ? err : static_cast<int>(cudaGetLastError());
  }
  if (variant != 1 && variant != 2) return static_cast<int>(cudaErrorInvalidValue);
  switch (b_dt) {
    case F32: err = launch_stream<float>(variant, p, sub, stream); break;
    case BF16: err = launch_stream<__nv_bfloat16>(variant, p, sub, stream); break;
    case F16: err = launch_stream<__half>(variant, p, sub, stream); break;
    case F8E4M3: err = launch_stream<__nv_fp8_e4m3>(variant, p, sub, stream); break;
    case I8: err = launch_stream<int8_t>(variant, p, sub, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return err ? err : static_cast<int>(cudaGetLastError());
}
