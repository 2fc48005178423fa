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
// Design.  One warp per row; a lane holds its columns in registers (up to
// kMaxVec chunks of 8, 16-byte loads), so x is read once and y written
// once.  The TPU kernel sums dgamma/dbeta across its sequential grid into
// one [1, C] block; on a GPU blocks run concurrently, so that is a race.
// Here each block of the backward owns a contiguous run of rows, keeps
// its lanes' dgamma/dbeta sums in registers, combines its warps through
// shared memory in a fixed order and writes one f32 partial row
// [nparts, C]; a second kernel in this file sums the partials per column,
// again in a fixed order.  No atomics, so the result is deterministic.
//
// Bound.  Bytes: the forward reads x and writes y (plus 8 bytes a row of
// stats), the backward reads x and dy and writes dx; the arithmetic is a
// few operations per element.  One warp per row with every load a
// 16-byte vector keeps the bytes at that minimum; the partials add
// nparts x C x 8 bytes, small next to the rows.
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
constexpr int kRedRows = 8;        // partial rows summed per reduce thread column

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
// Block p owns rows [p * rpb, min(rows, (p + 1) * rpb)); its warps take
// every kBwdWarps-th row.  Writes dx and the block's partial sums
// partials[0][p][:] (dgamma) and partials[1][p][:] (dbeta).
template <typename T, int V>
__global__ void __launch_bounds__(kBwdWarps * 32)
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
              const float* __restrict__ mu, const float* __restrict__ rstd,
              const T* __restrict__ dy, T* __restrict__ dx,
              float* __restrict__ partials, int rows, int C, int rpb) {
  extern __shared__ float red[];  // [kBwdWarps][C]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r_begin = blockIdx.x * rpb;
  const int r_end = min(rows, r_begin + rpb);

  float g[V][8], dg[V][8], db[V][8];
#pragma unroll
  for (int c = 0; c < V; ++c) {
    const int col = chunk_col(c, lane);
    if (col < C) load8(gamma + col, g[c]);
#pragma unroll
    for (int j = 0; j < 8; ++j) dg[c][j] = db[c][j] = 0.f;
  }

  for (int row = r_begin + warp; row < r_end; row += kBwdWarps) {
    const float m = mu[row], rs = rstd[row];
    const T* xr = x + (long long)row * C;
    const T* dyr = dy + (long long)row * C;
    float xh[V][8], w[V][8];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const int col = chunk_col(c, lane);
      if (col < C) {
        float xv[8], dv[8];
        load8(xr + col, xv);
        load8(dyr + col, dv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          xh[c][j] = (xv[j] - m) * rs;
          w[c][j] = dv[j] * g[c][j];
          s1 += w[c][j];
          s2 += w[c][j] * xh[c][j];
          dg[c][j] += dv[j] * xh[c][j];
          db[c][j] += dv[j];
        }
      }
    }
    const float c1 = warp_sum(s1) / C;
    const float c2 = warp_sum(s2) / C;
    T* dxr = dx + (long long)row * C;
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const int col = chunk_col(c, lane);
      if (col < C) {
        float o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = (w[c][j] - c1 - xh[c][j] * c2) * rs;
        store8(dxr + col, o);
      }
    }
  }

  // combine the warps in a fixed order, first dgamma then dbeta
  for (int which = 0; which < 2; ++which) {
    __syncthreads();
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const int col = chunk_col(c, lane);
      if (col < C) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          red[warp * C + col + j] = which == 0 ? dg[c][j] : db[c][j];
      }
    }
    __syncthreads();
    float* out = partials + ((long long)which * gridDim.x + blockIdx.x) * C;
    for (int col = threadIdx.x; col < C; col += blockDim.x) {
      float s = 0.f;
      for (int wi = 0; wi < kBwdWarps; ++wi) s += red[wi * C + col];
      out[col] = s;
    }
  }
}

// Sums partials [2][nparts][C] over nparts into out [2][C].  Block (32,
// kRedRows) covers 32 columns of one of the two sums; thread row ty takes
// every kRedRows-th partial, then the rows are added in order.
__global__ void __launch_bounds__(32 * kRedRows)
ln_reduce_kernel(const float* __restrict__ partials, int nparts, int C,
                 float* __restrict__ out) {
  __shared__ float acc[kRedRows][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + tx;
  const int which = blockIdx.y;
  const float* base = partials + (long long)which * nparts * C;
  float s = 0.f;
  if (col < C)
    for (int p = ty; p < nparts; p += kRedRows) s += base[(long long)p * C + col];
  acc[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && col < C) {
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < kRedRows; ++r) t += acc[r][tx];
    out[which * C + col] = t;
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

template <typename T, int V>
int launch_bwd(const void* x, const void* g, const float* mu,
               const float* rstd, const void* dy, void* dx, float* partials,
               float* dgdb, int rows, int C, int rpb, cudaStream_t s) {
  const int nparts = (rows + rpb - 1) / rpb;
  const size_t smem = sizeof(float) * kBwdWarps * C;
  static bool raised = false;  // once, before any graph capture
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        ln_bwd_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * kBwdWarps * 256 * kMaxVec));
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  ln_bwd_kernel<T, V><<<nparts, kBwdWarps * 32, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), mu, rstd,
      static_cast<const T*>(dy), static_cast<T*>(dx), partials, rows, C, rpb);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ln_reduce_kernel<<<dim3((C + 31) / 32, 2), 32 * kRedRows, 0, s>>>(
      partials, nparts, C, dgdb);
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

// The row pass (dx and per-block partials) and the reduction of the
// partials, on ``stream``.  ``partials`` is f32 scratch [2][nparts][C]
// with nparts = ceil(rows / rows_per_block); ``dgdb`` receives f32
// [2][C]: dgamma, then dbeta.
extern "C" int layernorm_bwd(const void* x, const void* gamma,
                             const float* mu, const float* rstd,
                             const void* dy, void* dx, float* partials,
                             float* dgdb, int dtype, int rows, int C,
                             int rows_per_block, void* stream) {
  if (!shape_ok(rows, C) || rows_per_block < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int vec = (C + 255) / 256;
  if (dtype == 0) { LN_DISPATCH(float, launch_bwd, x, gamma, mu, rstd, dy, dx, partials, dgdb, rows, C, rows_per_block, s) }
  if (dtype == 1) { LN_DISPATCH(__nv_bfloat16, launch_bwd, x, gamma, mu, rstd, dy, dx, partials, dgdb, rows, C, rows_per_block, s) }
  return (int)cudaErrorInvalidValue;
}
