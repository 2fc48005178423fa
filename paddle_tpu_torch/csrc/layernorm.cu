// Row LayerNorm, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of
//   paddle_tpu/ops/pallas/layernorm_kernel.py ::
//     _ln_fwd  (body _fwd_kernel)  -> layernorm_fwd below
//     _ln_bwd  (body _bwd_kernel)  -> layernorm_bwd below
//
// What it computes.  x [rows, C], gamma and beta [C] (one dtype, f32 or
// bf16).  Forward, per row, in f32: mu = mean(x), the centred variance
// var = mean((x - mu)^2) (not E[x^2] - mu^2, as _fwd_kernel computes it),
// rstd = rsqrt(var + eps), y = (x - mu) * rstd * gamma + beta in x's
// dtype, and mu, rstd as f32 [rows].  Backward from the saved stats:
// xhat = (x - mu) * rstd, wdy = dy * gamma,
// dx = (wdy - mean(wdy) - xhat * mean(wdy * xhat)) * rstd in x's dtype,
// dgamma = sum over rows of dy * xhat and dbeta = sum of dy, in f32.
//
// Bound.  Bytes: the forward reads x and writes y (plus 8 bytes a row of
// stats), the backward reads x and dy and writes dx; the arithmetic is a
// few operations per element.  Every row load and store is a 16-byte
// vector, so the bytes stay at that minimum.
//
// Forward.  One warp per row; a lane holds its columns in registers (up
// to kMaxVec chunks of 8), so x is read once and y written once.
//
// Backward.  The TPU kernel sums dgamma/dbeta across its sequential grid
// into one [1, C] block; on a GPU blocks run concurrently, so that is a
// race.  Here the row pass runs as one wave: the host sizes its grid to
// the blocks that fit on the card at once (blocks per SM from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SM count, read
// once, layernorm_bwd_info) and no more than one block per kBwdWarps
// rows, and block b owns rows [b * rows / grid, (b + 1) * rows / grid).
// Its warps take every kBwdWarps-th row of that run.  Each warp streams
// its rows through its own ring of kRingSlots row slots in shared memory:
// row k + 1's x and dy (and its mu and rstd) arrive by cp.async while row
// k is reduced and stored, so every warp has a row in flight without
// holding it in registers (48 KB of ring a block at C = 768 bf16).  A
// lane reads back only the 16-byte pieces it copied, so the ring needs no
// barrier.  gamma sits in shared memory in f32.  A lane keeps its
// columns' dgamma/dbeta sums in registers and recomputes xhat and wdy
// from the slot in the second pass instead of holding them, so the bf16
// kernel at C = 768 takes 96 registers, two blocks (16 warps) an SM.  At
// the end a block adds its warps' sums through shared memory in warp
// order and writes one f32 partial row [2 * C] (dgamma, then dbeta);
// ln_reduce_kernel then sums the grid's partials over C / 4 blocks of 8
// columns each (192 at C = 768), each column's partials added in a fixed
// order.  No atomics: for one shape on one card the grid, and so the
// sum's order, is always the same, and dgamma/dbeta are bitwise
// repeatable, graph replays included.
//
// What this replaced (the earlier backward at 8192 x 768 bf16 on an
// H100 80GB HBM3 at 700 W, 0.0306 ms against a 0.0113 ms bound): 32
// rows a block, 256 blocks of 8 warps at
// one block an SM (xhat and wdy held as 48 f32 a lane beside the sums),
// so two waves, the second 124 blocks; a warp's rows one after another
// with nothing in flight during a row's shuffles; and a reduce of 256
// partial rows over 48 blocks.  Why these sizes: at that shape more ring
// slots, more or fewer warps a block and a grid of other than one wave
// all read slower (``python3 chip_smoke.py ln_bwd_designs`` times them
// side by side; readings in PERF.md, B4b).  Two designs were tried and
// dropped: the next row held in a second set of registers (at 128
// registers the compiler did not load it early), and the rows brought in
// by Hopper's bulk copy onto an mbarrier, one thread a row, which read
// slower than the per-lane copies.  What holds the row pass above its
// bound is the memory system, not the arithmetic: with the arithmetic
// taken out it reads within 0.5 us of the full kernel.
//
// Needs: C % 8 == 0, 8 <= C <= 32 * 8 * kMaxVec, 16-byte aligned
// pointers, rows >= 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxVec = 8;         // chunks of 8 columns per lane: C <= 2048
constexpr int kFwdWarps = 4;       // rows per forward block
constexpr int kBwdWarps = 8;       // warps per backward block
constexpr int kRingSlots = 2;      // row slots in a warp's ring: one row ahead
constexpr int kRedCols = 8;        // columns per reduce block
constexpr int kRedThreads = 256;   // a reduce block: 32 partial lanes x kRedCols

__device__ __forceinline__ void load8(const float* src, float* dst) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* dst, const float* x) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* x) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// first column of a lane's chunk c
__device__ __forceinline__ int chunk_col(int c, int lane) { return (c * 32 + lane) * 8; }

// ---------------------------------------------------------------- forward --
template <typename T, int V>
__global__ void __launch_bounds__(kFwdWarps * 32)
ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
              const T* __restrict__ beta, T* __restrict__ y,
              float* __restrict__ mu_out, float* __restrict__ rstd_out,
              int rows, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kFwdWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform
  const T* xr = x + (long long)row * C;
  float v[V][8];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < V; ++c) {
    const int col = chunk_col(c, lane);
    if (col < C) {
      load8(xr + col, v[c]);
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += v[c][j];
    }
  }
  const float mu = warp_sum(sum) / C;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < V; ++c) {
    if (chunk_col(c, lane) < C) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = v[c][j] - mu;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / C + eps);
  T* yr = y + (long long)row * C;
#pragma unroll
  for (int c = 0; c < V; ++c) {
    const int col = chunk_col(c, lane);
    if (col < C) {
      float g[8], b[8], o[8];
      load8(gamma + col, g);
      load8(beta + col, b);
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = (v[c][j] - mu) * rstd * g[j] + b[j];
      store8(yr + col, o);
    }
  }
  if (lane == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

// --------------------------------------------------------------- backward --
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of BYTES (4 or 16) from global to shared; 16-byte copies
// bypass L1
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                 "l"(src), "n"(BYTES));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The row pass's sizes for one (T, V).  A warp's ring holds kRingSlots
// rows of x and dy at the widest C of this V, or one row where the
// block's rings would pass 192 KB (f32 at C > 1024).  kMinBlocks is the
// residency its registers are held to: the dgamma/dbeta sums are 16 V
// f32 a lane, so up to V = 4 a thread fits in 128 registers and two
// blocks share an SM.
template <typename T, int V>
struct BwdTraits {
  static constexpr int kRowBytes = 2 * 256 * V * (int)sizeof(T);
  static constexpr int kStages =
      kBwdWarps * kRingSlots * kRowBytes <= 192 * 1024 ? kRingSlots : 1;
  static constexpr int kMinBlocks = V <= 4 ? 2 : 1;
};

// Shared memory of the row pass at C columns: gamma in f32 [C]; each
// warp's row stats [kStages][2]; then each warp's ring [kStages][2][C]
// of T, which the block's warp sums [kBwdWarps][2C] f32 reuse at the end.
template <typename T, int V>
__host__ __device__ constexpr int bwd_smem(int C) {
  constexpr int S = BwdTraits<T, V>::kStages;
  const int ring = kBwdWarps * S * 2 * C * (int)sizeof(T);
  const int red = kBwdWarps * 2 * C * (int)sizeof(float);
  return C * 4 + kBwdWarps * S * 8 + (ring > red ? ring : red);
}

// Block b of gridDim.x owns rows [b * rows / grid, (b + 1) * rows / grid);
// its warps take every kBwdWarps-th row.  A warp keeps kStages - 1 rows
// in flight: row k's x and dy land by cp.async in ring slot k % kStages
// (each lane copies, and later reads, only its own 16-byte pieces, so no
// barrier is needed), and lanes 0 and 1 copy its mu and rstd beside
// them.  Writes dx and the block's partial row partials[b][0:C]
// (dgamma), partials[b][C:2C] (dbeta).
template <typename T, int V>
__global__ void __launch_bounds__(kBwdWarps * 32, (BwdTraits<T, V>::kMinBlocks))
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
              const float* __restrict__ mu, const float* __restrict__ rstd,
              const T* __restrict__ dy, T* __restrict__ dx,
              float* __restrict__ partials, int rows, int C) {
  constexpr int S = BwdTraits<T, V>::kStages;
  constexpr int kPieces = 8 * (int)sizeof(T) / 16;  // 16-byte copies a chunk
  extern __shared__ float4 smem4[];
  float* gs = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* stats = gs + C + warp * S * 2;
  T* ring = reinterpret_cast<T*>(gs + C + kBwdWarps * S * 2) +
            warp * S * 2 * C;
  const long long r_begin = (long long)blockIdx.x * rows / gridDim.x;
  const long long r_end = (long long)(blockIdx.x + 1) * rows / gridDim.x;
  const long long first = r_begin + warp;
  const int n = first < r_end
                    ? (int)((r_end - first + kBwdWarps - 1) / kBwdWarps)
                    : 0;

  // row k of this warp into slot k % S; one commit group, empty past n
  auto issue = [&](int k) {
    if (k < n) {
      const long long row = first + (long long)k * kBwdWarps;
      T* slot = ring + (k % S) * 2 * C;
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const int col = chunk_col(c, lane);
        if (col < C) {
#pragma unroll
          for (int q = 0; q < kPieces; ++q) {
            const int e = col + q * 16 / (int)sizeof(T);
            cp_async<16>(smem_u32(slot + e), x + row * C + e);
            cp_async<16>(smem_u32(slot + C + e), dy + row * C + e);
          }
        }
      }
      if (lane < 2)
        cp_async<4>(smem_u32(stats + (k % S) * 2 + lane),
                    (lane == 0 ? mu : rstd) + row);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int k = 0; k < S - 1; ++k) issue(k);
  for (int i = threadIdx.x; i < C; i += blockDim.x) gs[i] = to_f32(gamma[i]);
  __syncthreads();

  float dg[V][8], db[V][8];
#pragma unroll
  for (int c = 0; c < V; ++c) {
#pragma unroll
    for (int j = 0; j < 8; ++j) dg[c][j] = db[c][j] = 0.f;
  }

  for (int k = 0; k < n; ++k) {
    issue(k + S - 1);      // into the slot row k - 1 left
    cp_async_wait<S - 1>();  // row k has landed
    __syncwarp();          // lanes 0 and 1's stats are seen by all
    const T* slot = ring + (k % S) * 2 * C;
    const float m = stats[(k % S) * 2], rs = stats[(k % S) * 2 + 1];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const int col = chunk_col(c, lane);
      if (col < C) {
        float xv[8], dv[8], g[8];
        load8(slot + col, xv);
        load8(slot + C + col, dv);
        load8(gs + col, g);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xh = (xv[j] - m) * rs;
          const float w = dv[j] * g[j];
          s1 += w;
          s2 += w * xh;
          dg[c][j] += dv[j] * xh;
          db[c][j] += dv[j];
        }
      }
    }
    const float c1 = warp_sum(s1) / C;
    const float c2 = warp_sum(s2) / C;
    T* dxr = dx + (first + (long long)k * kBwdWarps) * C;
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const int col = chunk_col(c, lane);
      if (col < C) {
        float xv[8], dv[8], g[8], o[8];
        load8(slot + col, xv);
        load8(slot + C + col, dv);
        load8(gs + col, g);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xh = (xv[j] - m) * rs;
          o[j] = (dv[j] * g[j] - c1 - xh * c2) * rs;
        }
        store8(dxr + col, o);
      }
    }
    __syncwarp();          // every lane has read the stats before reuse
  }
  cp_async_wait<0>();

  // the warps' sums, added in warp order into one partial row; they
  // reuse the rings, so every warp must be done with its own first
  float* red = gs + C + kBwdWarps * S * 2;
  __syncthreads();
#pragma unroll
  for (int c = 0; c < V; ++c) {
    const int col = chunk_col(c, lane);
    if (col < C) {
      store8(red + warp * 2 * C + col, dg[c]);
      store8(red + warp * 2 * C + C + col, db[c]);
    }
  }
  __syncthreads();
  float* out = partials + (long long)blockIdx.x * 2 * C;
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) s += red[w * 2 * C + i];
    out[i] = s;
  }
}

// Sums partials [nparts][C2] over nparts into out [C2] (C2 = 2C: dgamma,
// then dbeta).  Block b covers columns [b * kRedCols, (b + 1) * kRedCols);
// thread t takes column t % kRedCols of every kLanes-th partial from
// t / kRedCols, then the lanes are added in order.
__global__ void __launch_bounds__(kRedThreads)
ln_reduce_kernel(const float* __restrict__ partials, int nparts, int C2,
                 float* __restrict__ out) {
  constexpr int kLanes = kRedThreads / kRedCols;
  __shared__ float acc[kLanes][kRedCols];
  const int tx = threadIdx.x % kRedCols, ty = threadIdx.x / kRedCols;
  const int col = blockIdx.x * kRedCols + tx;  // C2 % kRedCols == 0
  float s = 0.f;
#pragma unroll 4
  for (int p = ty; p < nparts; p += kLanes) s += partials[(long long)p * C2 + col];
  acc[ty][tx] = s;
  __syncthreads();
  if (ty == 0) {
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < kLanes; ++r) t += acc[r][tx];
    out[col] = t;
  }
}

bool shape_ok(int rows, int C) {
  return rows >= 1 && C >= 8 && C % 8 == 0 && C <= 256 * kMaxVec;
}

template <typename T, int V>
int launch_fwd(const void* x, const void* g, const void* b, void* y,
               float* mu, float* rstd, int rows, int C, float eps,
               cudaStream_t s) {
  const int blocks = (rows + kFwdWarps - 1) / kFwdWarps;
  ln_fwd_kernel<T, V><<<blocks, kFwdWarps * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(b), static_cast<T*>(y), mu, rstd, rows, C, eps);
  return (int)cudaGetLastError();
}

// Raises the row pass's shared-memory limit to what the widest C of this
// V needs and asks for the largest shared carveout; once per kernel, at
// the first info query or launch (before any graph capture).
template <typename T, int V>
int prepare_bwd() {
  static int err = -1;
  if (err < 0) {
    err = (int)cudaFuncSetAttribute(
        ln_bwd_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bwd_smem<T, V>(256 * V));
    if (err == 0)
      err = (int)cudaFuncSetAttribute(
          ln_bwd_kernel<T, V>, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
  }
  return err;
}

template <typename T, int V>
int info_bwd(int* out) {
  int err = prepare_bwd<T, V>();
  if (err) return err;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, ln_bwd_kernel<T, V>);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, ln_bwd_kernel<T, V>, kBwdWarps * 32, bwd_smem<T, V>(256 * V));
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks;
  out[3] = sms;
  out[4] = bwd_smem<T, V>(256 * V);
  out[5] = BwdTraits<T, V>::kStages;
  return 0;
}

template <typename T, int V>
int launch_bwd(const void* x, const void* g, const float* mu,
               const float* rstd, const void* dy, void* dx, float* partials,
               float* dgdb, int rows, int C, int nparts, cudaStream_t s) {
  const int err = prepare_bwd<T, V>();
  if (err) return err;
  ln_bwd_kernel<T, V><<<nparts, kBwdWarps * 32, bwd_smem<T, V>(C), s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), mu, rstd,
      static_cast<const T*>(dy), static_cast<T*>(dx), partials, rows, C);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ln_reduce_kernel<<<2 * C / kRedCols, kRedThreads, 0, s>>>(
      partials, nparts, 2 * C, dgdb);
  return (int)cudaGetLastError();
}

#define LN_DISPATCH(T, FN, ...)                         \
  switch (vec) {                                        \
    case 1: return FN<T, 1>(__VA_ARGS__);               \
    case 2: return FN<T, 2>(__VA_ARGS__);               \
    case 3: return FN<T, 3>(__VA_ARGS__);               \
    case 4: return FN<T, 4>(__VA_ARGS__);               \
    default: return FN<T, kMaxVec>(__VA_ARGS__);        \
  }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, gamma, beta and y share it).
// mu and rstd are f32 [rows].  Launches on ``stream`` and returns
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int layernorm_fwd(const void* x, const void* gamma,
                             const void* beta, void* y, float* mu,
                             float* rstd, int dtype, int rows, int C,
                             float eps, void* stream) {
  if (!shape_ok(rows, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int vec = (C + 255) / 256;
  if (dtype == 0) { LN_DISPATCH(float, launch_fwd, x, gamma, beta, y, mu, rstd, rows, C, eps, s) }
  if (dtype == 1) { LN_DISPATCH(__nv_bfloat16, launch_fwd, x, gamma, beta, y, mu, rstd, rows, C, eps, s) }
  return (int)cudaErrorInvalidValue;
}

// The backward row kernel for C columns of ``dtype`` on the current
// device: out[0..5] = registers a thread, local (spill) bytes a thread,
// blocks resident per SM, the SM count, dynamic shared bytes, and the
// row slots in each warp's ring.  A device query: the host calls it once
// per kernel and caches the result.
extern "C" int layernorm_bwd_info(int dtype, int C, int* out) {
  if (!shape_ok(1, C)) return (int)cudaErrorInvalidValue;
  const int vec = (C + 255) / 256;
  if (dtype == 0) { LN_DISPATCH(float, info_bwd, out) }
  if (dtype == 1) { LN_DISPATCH(__nv_bfloat16, info_bwd, out) }
  return (int)cudaErrorInvalidValue;
}

// The row pass (dx and one partial row per block, over ``nparts``
// blocks) and the reduction of the partials, on ``stream``.
// ``partials`` is f32 scratch [nparts][2][C]; ``dgdb`` receives f32
// [2][C]: dgamma, then dbeta.
extern "C" int layernorm_bwd(const void* x, const void* gamma,
                             const float* mu, const float* rstd,
                             const void* dy, void* dx, float* partials,
                             float* dgdb, int dtype, int rows, int C,
                             int nparts, void* stream) {
  if (!shape_ok(rows, C) || nparts < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int vec = (C + 255) / 256;
  if (dtype == 0) { LN_DISPATCH(float, launch_bwd, x, gamma, mu, rstd, dy, dx, partials, dgdb, rows, C, nparts, s) }
  if (dtype == 1) { LN_DISPATCH(__nv_bfloat16, launch_bwd, x, gamma, mu, rstd, dy, dx, partials, dgdb, rows, C, nparts, s) }
  return (int)cudaErrorInvalidValue;
}
