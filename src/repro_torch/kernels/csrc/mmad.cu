// mmad: C = A @ B with fp32 accumulation, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `repro/kernels/mmad.py:_mmad_kernel`. That
// kernel walks an (M/bm, N/bn, K/bk) grid in order on one TensorCore and
// carries an fp32 VMEM accumulator across the sequential K axis. Here CTAs
// run in parallel and in no order, so:
//
//   * one CTA owns one output tile and loops over its K range itself (the
//     sequential K grid axis becomes a loop inside the CTA);
//   * when too few output tiles exist to fill the card (decode: M = 4,
//     N = 256..2048), K is split over a third grid axis; each split writes
//     an fp32 partial and a second kernel sums the partials in split order
//     and casts (deterministic, no atomics);
//   * the ragged edge is masked in the loads and stores, and A and B are read
//     through their strides, so the wrapper never pads or copies (the tied
//     lm_head weight is the strided view embed.T).
//
// Three variants: two stream kernels for few rows of A (decode), which read
// the weight once with 16-byte vector loads straight into registers — the
// row stream when B's rows are contiguous, the column stream when its
// columns are (embed.T) — and a 64 x 64 tile kernel that stages fp32 tiles
// in shared memory and takes any strides.
//
// Numerics: every operand element converts exactly to fp32 on load (fp32,
// bf16, fp16, fp8 e4m3, int8), products and sums are IEEE fp32 FMAs on the
// CUDA cores (never TF32), and the output is rounded once to out_dtype.
//
// Bound on this card: at decode batch sizes the product streams the weight
// B once and does 2*M FLOPs per weight element, far below the ~295 FLOP/byte
// ridge of an H100, so it is bound by device-memory bytes. The stream
// kernels therefore spend nothing on B but the load: 16-byte vectors,
// coalesced along B's contiguous dim, several in flight per lane, fp32 FMAs
// against the few rows of A broadcast from shared memory, and a K split
// until the grid covers the SMs. The plan's block geometry does not shape
// these kernels (the tile kernel reads only bk, as its split-K unit);
// wgmma/TMA, the plan's geometry and its pipeline depth are later work.
//
// Plain C interface (bound with ctypes); launches on the caller's stream and
// returns cudaGetLastError().

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
// Skinny-M kernels for decode (M = batch rows): the weight B is streamed
// once with 16-byte vector loads and never staged; the few rows of A are
// staged in shared memory as fp32 and broadcast. Each CTA handles SK_MT rows
// of A (grid.y walks M).
// ---------------------------------------------------------------------------

constexpr int SK_MT = 4;        // rows of A per CTA
constexpr int SK_WARPS = 8;     // warps per CTA
constexpr int SK_NT = SK_WARPS * 32;
constexpr int SK_COLS = 8;      // columns per warp in the column-stream kernel

template <typename TB>
__device__ __forceinline__ void load_vec(const TB* p, float (&out)[16 / sizeof(TB)]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  TB e[16 / sizeof(TB)];
  memcpy(e, &raw, 16);
#pragma unroll
  for (int v = 0; v < 16 / static_cast<int>(sizeof(TB)); ++v) out[v] = to_f32<TB>(e[v]);
}

__device__ __forceinline__ void emit(void* C, float* ws, int c_dt, int splits, long long M,
                                     long long N, long long m, long long n, float v) {
  if (splits == 1) {
    store_any(C, m * N + n, c_dt, v);
  } else {
    ws[(static_cast<long long>(blockIdx.z) * M + m) * N + n] = v;
  }
}

// B row-major (n contiguous, 16-byte aligned rows): a lane owns VEC
// consecutive columns and reads them from one k row per 16-byte load, so a
// warp reads 512 contiguous bytes per row. The CTA's warps take interleaved
// k rows of the same 32*VEC columns; their partials are summed through
// shared memory at the end.
template <typename TB>
__global__ void __launch_bounds__(SK_NT)
mmad_rows_kernel(const void* __restrict__ A, const TB* __restrict__ B, void* __restrict__ C,
                 float* __restrict__ ws, int a_dt, int c_dt, long long M, long long N,
                 long long K, long long sam, long long sak, long long sbk, long long kps,
                 int splits) {
  constexpr int VEC = 16 / sizeof(TB);
  constexpr int KC = 256;                       // rows of A staged per chunk
  __shared__ float As[SK_MT][KC];
  __shared__ float red[SK_WARPS][VEC][32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long m0 = static_cast<long long>(blockIdx.y) * SK_MT;
  const long long c0 = static_cast<long long>(blockIdx.x) * (32 * VEC);
  const long long n = c0 + lane * VEC;
  const long long kbeg = static_cast<long long>(blockIdx.z) * kps;
  const long long kend = (kbeg + kps < K) ? kbeg + kps : K;

  float acc[SK_MT][VEC];
#pragma unroll
  for (int m = 0; m < SK_MT; ++m)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[m][v] = 0.f;

  for (long long kc = kbeg; kc < kend; kc += KC) {
    const int klen = static_cast<int>((kend - kc < KC) ? kend - kc : KC);
    __syncthreads();                            // the last chunk's readers are done
    for (int idx = threadIdx.x; idx < SK_MT * KC; idx += SK_NT) {
      const int r = idx / KC, c = idx % KC;
      As[r][c] = (m0 + r < M && c < klen)
                     ? load_any(A, (m0 + r) * sam + (kc + c) * sak, a_dt) : 0.f;
    }
    __syncthreads();
    if (n < N) {
      const TB* bp = B + kc * sbk + n;
#pragma unroll 4
      for (int kk = warp; kk < klen; kk += SK_WARPS) {
        float b[VEC];
        load_vec<TB>(bp + kk * sbk, b);
#pragma unroll
        for (int m = 0; m < SK_MT; ++m) {
          const float a = As[m][kk];
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[m][v] = fmaf(a, b[v], acc[m][v]);
        }
      }
    }
  }

  // sum the warps' partials, one row of A at a time, in warp order
#pragma unroll
  for (int m = 0; m < SK_MT; ++m) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) red[warp][v][lane] = acc[m][v];
    __syncthreads();
    for (int idx = threadIdx.x; idx < VEC * 32; idx += SK_NT) {
      const int v = idx / 32, l = idx % 32;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < SK_WARPS; ++w) s += red[w][v][l];
      const long long col = c0 + l * VEC + v;
      if (m0 + m < M && col < N) emit(C, ws, c_dt, splits, M, N, m0 + m, col, s);
    }
    __syncthreads();
  }
}

// B column-major (k contiguous, 16-byte aligned columns — the tied lm_head
// weight embed.T): a warp owns SK_COLS columns and its lanes split K, each
// lane reading VEC consecutive k of a column per 16-byte load (512
// contiguous bytes per warp); lanes' partials meet in a warp shuffle. The
// staged A chunk is laid out [row][v][lane] so the lanes' reads of their
// own k slots hit distinct banks.
template <typename TB>
__global__ void __launch_bounds__(SK_NT)
mmad_cols_kernel(const void* __restrict__ A, const TB* __restrict__ B, void* __restrict__ C,
                 float* __restrict__ ws, int a_dt, int c_dt, long long M, long long N,
                 long long K, long long sam, long long sak, long long sbn, long long kps,
                 int splits) {
  constexpr int VEC = 16 / sizeof(TB);
  constexpr int KC = 32 * VEC;                  // one vector per lane per column
  __shared__ float As[SK_MT][VEC][32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long m0 = static_cast<long long>(blockIdx.y) * SK_MT;
  const long long nb = (static_cast<long long>(blockIdx.x) * SK_WARPS + warp) * SK_COLS;
  const long long kbeg = static_cast<long long>(blockIdx.z) * kps;
  const long long kend = (kbeg + kps < K) ? kbeg + kps : K;

  float acc[SK_MT][SK_COLS];
#pragma unroll
  for (int m = 0; m < SK_MT; ++m)
#pragma unroll
    for (int c = 0; c < SK_COLS; ++c) acc[m][c] = 0.f;

  for (long long kc = kbeg; kc < kend; kc += KC) {
    const int klen = static_cast<int>((kend - kc < KC) ? kend - kc : KC);
    __syncthreads();
    for (int idx = threadIdx.x; idx < SK_MT * KC; idx += SK_NT) {
      const int r = idx / KC, k = idx % KC;
      As[r][k % VEC][k / VEC] = (m0 + r < M && k < klen)
                                    ? load_any(A, (m0 + r) * sam + (kc + k) * sak, a_dt)
                                    : 0.f;
    }
    __syncthreads();
    if (lane * VEC < klen) {                    // K and kps are whole vectors
      float b[SK_COLS][VEC];
#pragma unroll
      for (int c = 0; c < SK_COLS; ++c) {
        if (nb + c < N) {
          load_vec<TB>(B + (nb + c) * sbn + kc + lane * VEC, b[c]);
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) b[c][v] = 0.f;
        }
      }
#pragma unroll
      for (int m = 0; m < SK_MT; ++m) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float a = As[m][v][lane];
#pragma unroll
          for (int c = 0; c < SK_COLS; ++c) acc[m][c] = fmaf(a, b[c][v], acc[m][c]);
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < SK_MT; ++m)
#pragma unroll
    for (int c = 0; c < SK_COLS; ++c)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], off);
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < SK_MT; ++m)
#pragma unroll
      for (int c = 0; c < SK_COLS; ++c)
        if (m0 + m < M && nb + c < N) emit(C, ws, c_dt, splits, M, N, m0 + m, nb + c, acc[m][c]);
  }
}

// variant 0: tile, 64 x 64, a 4 x 4 register block per thread;
// variant 1: row stream (B n-contiguous, 16-byte aligned);
// variant 2: column stream (B k-contiguous, 16-byte aligned)
template <typename TB>
void launch_tile(int variant, const void* a, const void* b, void* c, float* ws, int a_dt,
                 int c_dt, long long M, long long N, long long K, long long sam,
                 long long sak, long long sbk, long long sbn, long long kps, int splits,
                 cudaStream_t stream) {
  const TB* bt = static_cast<const TB*>(b);
  constexpr long long VEC = 16 / sizeof(TB);
  if (variant == 1) {
    dim3 grid((N + 32 * VEC - 1) / (32 * VEC), (M + SK_MT - 1) / SK_MT, splits);
    mmad_rows_kernel<TB><<<grid, SK_NT, 0, stream>>>(a, bt, c, ws, a_dt, c_dt, M, N, K, sam,
                                                     sak, sbk, kps, splits);
  } else if (variant == 2) {
    constexpr long long PER_CTA = SK_WARPS * SK_COLS;
    dim3 grid((N + PER_CTA - 1) / PER_CTA, (M + SK_MT - 1) / SK_MT, splits);
    mmad_cols_kernel<TB><<<grid, SK_NT, 0, stream>>>(a, bt, c, ws, a_dt, c_dt, M, N, K, sam,
                                                     sak, sbn, kps, splits);
  } else {
    constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
    mmad_tile_kernel<BM, BN, BK, TM, TN, TB><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
        a, bt, c, ws, a_dt, c_dt, M, N, K, sam, sak, sbk, sbn, kps, splits);
  }
}

}  // namespace

extern "C" int mmad_launch(const void* a, const void* b, void* c, void* ws, int a_dt,
                           int b_dt, int c_dt, long long M, long long N, long long K,
                           long long sam, long long sak, long long sbk, long long sbn,
                           long long kps, int splits, int variant, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* w = static_cast<float*>(ws);
  switch (b_dt) {
    case F32:
      launch_tile<float>(variant, a, b, c, w, a_dt, c_dt, M, N, K, sam, sak, sbk, sbn, kps,
                         splits, stream);
      break;
    case BF16:
      launch_tile<__nv_bfloat16>(variant, a, b, c, w, a_dt, c_dt, M, N, K, sam, sak, sbk,
                                 sbn, kps, splits, stream);
      break;
    case F16:
      launch_tile<__half>(variant, a, b, c, w, a_dt, c_dt, M, N, K, sam, sak, sbk, sbn, kps,
                          splits, stream);
      break;
    case F8E4M3:
      launch_tile<__nv_fp8_e4m3>(variant, a, b, c, w, a_dt, c_dt, M, N, K, sam, sak, sbk,
                                 sbn, kps, splits, stream);
      break;
    case I8:
      launch_tile<int8_t>(variant, a, b, c, w, a_dt, c_dt, M, N, K, sam, sak, sbk, sbn, kps,
                          splits, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (splits > 1) {
    const long long mn = M * N;
    const int threads = 256;
    mmad_splitk_reduce<<<static_cast<unsigned>((mn + threads - 1) / threads), threads, 0,
                         stream>>>(w, c, c_dt, mn, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
