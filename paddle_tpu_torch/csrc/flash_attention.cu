// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of
//   paddle_tpu/ops/pallas/attention_kernel.py ::
//     _flash_fwd  (body _fwd_kernel)      -> flash_attention_fwd below
//     _flash_bwd  (body _bwd_dq_kernel)   -> flash_attention_bwd, dq pass
//     _flash_bwd  (body _bwd_dkv_kernel)  -> flash_attention_bwd, dk/dv pass
//
// What it computes.  q [B, Sq, N, D], k and v [B, Sk, N, D], read in
// place through element strides (batch, seq, head; the last dim is
// contiguous), so a [B, S, 3, N, D] qkv projection is read without the
// [B*N, S, D] transposes.  Per (b, n):
//   forward   O = softmax(scale * Q K^T) V and lse = m + log(l) (f32);
//   backward  P = exp(scale * Q K^T - lse), dP = dO V^T,
//             dS = P * (dP - delta) * scale with delta = rowsum(dO * O),
//             dQ = dS K, dK = dS^T Q, dV = P^T dO.
// With ``causal`` a query row attends to key columns col <= row (top-left
// alignment, as _fwd_kernel's ``rows >= cols``); the dispatcher only sends
// seq_q == seq_k there, where it equals the bottom-right alignment of the
// plain composition.  Scale: the forward pre-scales q on its load into
// shared memory (as _fwd_kernel does); both backward passes scale s after
// the product (as _bwd_dq_kernel and _bwd_dkv_kernel do).  Inputs f32 or
// bf16; products, softmax and accumulators are f32.
//
// Design.  The TPU kernels hold a whole [S, D] K/V (or Q/dO) block in
// VMEM per program and loop over it.  Here a block of 256 threads owns a
// 64-row tile and streams the other operand through shared memory in
// 64-row tiles; every thread keeps a 4 x 4 patch of the score tile and a
// 4 x ceil(D/16) patch of its output rows in registers.  The score loop
// reads one float4 of the transposed row tile (two addresses per warp, a
// broadcast) and four scalars of the streamed tile (row stride D + 1, so
// sixteen lanes hit sixteen banks) per 16 FMAs.  Each output row is
// written by exactly one block: dq blocks loop over key tiles, dk/dv
// blocks over query tiles from the diagonal on, as the TPU split does, so
// the backward needs no atomics and is deterministic.  Tails of any
// length are masked in the kernel; causal blocks skip the key (query)
// tiles that the mask hides entirely.
//
// Bound.  At GPT-124M training shapes ([8, 1024, 12, 64] bf16, causal)
// the work is operations: about 12.9 GFLOP forward and 2.5 times that
// backward against about 50 MB and 100 MB of traffic.  These kernels run
// those operations as scalar f32 FMAs on the CUDA cores, not on the
// tensor cores, so they sit far above that bound; mma/wgmma tiles with a
// TMA-fed ring of K/V tiles are the later work that closes the gap.
//
// Needs: D % 8 == 0 and 8 <= D <= 128, every stride a multiple of 8
// elements and 16-byte aligned base pointers (16-byte vector loads), any
// Sq, Sk >= 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;              // query rows per tile
constexpr int kBK = 64;              // key rows per tile
constexpr int kThreads = 256;        // 16 x 16 threads, 4 x 4 scores each
constexpr int kMaxD = 128;
constexpr int kPadT = kBQ + 4;       // transposed tile row: float4-aligned
constexpr float kNegInf = -1e30f;

struct Layout {
  long long b, s, n;  // element strides of batch, sequence, head
};

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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// max / sum over the 16 lanes that share a row of the score patch
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [r0, r0 + 64) of one (b, n) slice into shared memory as f32 times
// ``mul``; rows at or past ``rows`` read as zeros.  Transposed: dst[d][r]
// with row length kPadT; otherwise dst[r][d] with row length D + 1.
template <typename T>
__device__ void load_tile_t(const T* base, long long stride, int r0, int rows,
                            int D, float mul, float* dst) {
  const int vecs = D / 8;
  for (int e = threadIdx.x; e < kBQ * vecs; e += kThreads) {
    const int r = e % kBQ;  // neighbouring lanes: neighbouring rows, so the
    const int dv = (e / kBQ) * 8;  // transposed stores hit distinct banks
    float x[8];
    if (r0 + r < rows) {
      load8(base + (long long)(r0 + r) * stride + dv, x);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(dv + j) * kPadT + r] = x[j] * mul;
  }
}

template <typename T>
__device__ void load_tile(const T* base, long long stride, int r0, int rows,
                          int D, float* dst) {
  const int vecs = D / 8;
  const int ld = D + 1;
  for (int e = threadIdx.x; e < kBK * vecs; e += kThreads) {
    const int r = e / vecs;
    const int dv = (e % vecs) * 8;
    float x[8];
    if (r0 + r < rows) {
      load8(base + (long long)(r0 + r) * stride + dv, x);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[r * ld + dv + j] = x[j];
  }
}

// ---------------------------------------------------------------- forward --
// Grid (ceil(Sq / 64), B * N).  Shared: qT [D][kPadT] (q * scale),
// ks / vs [64][D + 1], pT [64 keys][kPadT].
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int N, int Sq, int Sk, int D,
                 Layout lq, Layout lk, Layout lv, Layout lo, int causal,
                 float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* qT = smem;
  float* ks = qT + D * kPadT;
  float* vs = ks + kBK * ld;
  float* pT = vs + kBK * ld;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int bn = blockIdx.y;
  const int b = bn / N, n = bn % N;
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* kb = k + b * lk.b + n * lk.n;
  const T* vb = v + b * lv.b + n * lv.n;

  load_tile_t(q + b * lq.b + n * lq.n, lq.s, q0, Sq, D, scale, qT);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(Sk, q0 + kBQ) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(kb, lk.s, k0, Sk, D, ks);
    load_tile(vb, lv.s, k0, Sk, D, vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qT[d * kPadT + ty * 4]);
      const float qa[4] = {a.x, a.y, a.z, a.w};
      float kk[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qa[i] * kk[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      bool valid[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        valid[j] = col < Sk && (!causal || row >= col);
        if (valid[j]) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        pT[(tx + 16 * j) * kPadT + ty * 4 + i] = p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    const int nk = min(kBK, kv_end - k0);
    for (int key = 0; key < nk; ++key) {
      const float4 a = *reinterpret_cast<const float4*>(&pT[key * kPadT + ty * 4]);
      const float pa[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = tx + 16 * c;
        const float vv = d < D ? vs[key * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += pa[i] * vv;
      }
    }
  }

  T* ob = out + b * lo.b + n * lo.n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float lsafe = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / lsafe;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) store(ob + (long long)row * lo.s + d, acc[i][c] * inv);
    }
    if (tx == 0) lse[(long long)bn * Sq + row] = m[i] + logf(lsafe);
  }
}

// ------------------------------------------------------------ backward dq --
// Grid (ceil(Sq / 64), B * N).  Shared: qT, doT [D][kPadT], ks, vs
// [64][D + 1], dsT [64 keys][kPadT].
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int N, int Sq, int Sk, int D, Layout lq, Layout lk,
                    Layout lv, Layout ldo, Layout ldq, int causal,
                    float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* qT = smem;
  float* doT = qT + D * kPadT;
  float* ks = doT + D * kPadT;
  float* vs = ks + kBK * ld;
  float* dsT = vs + kBK * ld;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bn = blockIdx.y;
  const int b = bn / N, n = bn % N;
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* kb = k + b * lk.b + n * lk.n;
  const T* vb = v + b * lv.b + n * lv.n;

  load_tile_t(q + b * lq.b + n * lq.n, lq.s, q0, Sq, D, 1.f, qT);
  load_tile_t(dout + b * ldo.b + n * ldo.n, ldo.s, q0, Sq, D, 1.f, doT);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse_r[i] = row < Sq ? lse[(long long)bn * Sq + row] : 0.f;
    delta_r[i] = row < Sq ? delta[(long long)bn * Sq + row] : 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  const int kv_end = causal ? min(Sk, q0 + kBQ) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();
    load_tile(kb, lk.s, k0, Sk, D, ks);
    load_tile(vb, lv.s, k0, Sk, D, vs);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qT[d * kPadT + ty * 4]);
      const float4 o = *reinterpret_cast<const float4*>(&doT[d * kPadT + ty * 4]);
      const float qa[4] = {a.x, a.y, a.z, a.w};
      const float oa[4] = {o.x, o.y, o.z, o.w};
      float kk[4], vv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = ks[(tx + 16 * j) * ld + d];
        vv[j] = vs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += qa[i] * kk[j];
          dp[i][j] += oa[i] * vv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool valid = col < Sk && (!causal || row >= col);
        const float p = valid ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dsT[(tx + 16 * j) * kPadT + ty * 4 + i] =
            p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();

    const int nk = min(kBK, kv_end - k0);
    for (int key = 0; key < nk; ++key) {
      const float4 a = *reinterpret_cast<const float4*>(&dsT[key * kPadT + ty * 4]);
      const float da[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = tx + 16 * c;
        const float kk = d < D ? ks[key * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += da[i] * kk;
      }
    }
  }

  T* out = dq + b * ldq.b + n * ldq.n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) store(out + (long long)row * ldq.s + d, acc[i][c]);
    }
  }
}

// --------------------------------------------------------- backward dk/dv --
// Grid (ceil(Sk / 64), B * N).  Thread (ty, tx) keeps keys k0 + ty*4 + i
// and queries q0 + tx + 16 j.  Shared: kT, vT [D][kPadT] (this block's
// keys), qs, dos [64][D + 1], pS, dsS [64 queries][kPadT], lse, delta.
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int N, int Sq, int Sk, int D,
                     Layout lq, Layout lk, Layout lv, Layout ldo, Layout ldk,
                     Layout ldv, int causal, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* kT = smem;
  float* vT = kT + D * kPadT;
  float* qs = vT + D * kPadT;
  float* dos = qs + kBQ * ld;
  float* pS = dos + kBQ * ld;
  float* dsS = pS + kBQ * kPadT;
  float* lse_s = dsS + kBQ * kPadT;
  float* delta_s = lse_s + kBQ;

  const int kt = gridDim.x - 1 - blockIdx.x;  // longest causal loops first
  const int bn = blockIdx.y;
  const int b = bn / N, n = bn % N;
  const int k0 = kt * kBK;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* qb = q + b * lq.b + n * lq.n;
  const T* ob = dout + b * ldo.b + n * ldo.n;

  load_tile_t(k + b * lk.b + n * lk.n, lk.s, k0, Sk, D, 1.f, kT);
  load_tile_t(v + b * lv.b + n * lv.n, lv.s, k0, Sk, D, 1.f, vT);

  float acc_k[4][DC], acc_v[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // query tiles before this key tile's diagonal see none of its keys
  const int q_begin = causal ? (k0 / kBQ) * kBQ : 0;
  for (int q0 = q_begin; q0 < Sq; q0 += kBQ) {
    __syncthreads();
    load_tile(qb, lq.s, q0, Sq, D, qs);
    load_tile(ob, ldo.s, q0, Sq, D, dos);
    for (int r = threadIdx.x; r < kBQ; r += kThreads) {
      const bool live = q0 + r < Sq;
      lse_s[r] = live ? lse[(long long)bn * Sq + q0 + r] : 0.f;
      delta_s[r] = live ? delta[(long long)bn * Sq + q0 + r] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&kT[d * kPadT + ty * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&vT[d * kPadT + ty * 4]);
      const float ka[4] = {a.x, a.y, a.z, a.w};
      const float va[4] = {w.x, w.y, w.z, w.w};
      float qq[4], oo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qq[j] = qs[(tx + 16 * j) * ld + d];
        oo[j] = dos[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += ka[i] * qq[j];
          dp[i][j] += va[i] * oo[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = tx + 16 * j;
        const int row = q0 + qr;
        const bool valid = row < Sq && key < Sk && (!causal || row >= key);
        const float p = valid ? expf(s[i][j] * scale - lse_s[qr]) : 0.f;
        pS[qr * kPadT + ty * 4 + i] = p;
        dsS[qr * kPadT + ty * 4 + i] = p * (dp[i][j] - delta_s[qr]) * scale;
      }
    }
    __syncthreads();

    const int nq = min(kBQ, Sq - q0);
    for (int r = 0; r < nq; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&pS[r * kPadT + ty * 4]);
      const float4 g = *reinterpret_cast<const float4*>(&dsS[r * kPadT + ty * 4]);
      const float pa[4] = {a.x, a.y, a.z, a.w};
      const float da[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = tx + 16 * c;
        const float o = d < D ? dos[r * ld + d] : 0.f;
        const float x = d < D ? qs[r * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_v[i][c] += pa[i] * o;
          acc_k[i][c] += da[i] * x;
        }
      }
    }
  }

  T* kout = dk + b * ldk.b + n * ldk.n;
  T* vout = dv + b * ldv.b + n * ldv.n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= Sk) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        store(kout + (long long)key * ldk.s + d, acc_k[i][c]);
        store(vout + (long long)key * ldv.s + d, acc_v[i][c]);
      }
    }
  }
}

size_t fwd_smem(int D) { return sizeof(float) * (D * kPadT + 2 * kBK * (D + 1) + kBK * kPadT); }
size_t dq_smem(int D) { return sizeof(float) * (2 * D * kPadT + 2 * kBK * (D + 1) + kBK * kPadT); }
size_t dkv_smem(int D) {
  return sizeof(float) * (2 * D * kPadT + 2 * kBQ * (D + 1) + 2 * kBQ * kPadT + 2 * kBQ);
}

Layout layout(const long long* strides, int t) {
  return Layout{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
}

bool shape_ok(int D, int Sq, int Sk) {
  return D % 8 == 0 && D >= 8 && D <= kMaxD && Sq >= 1 && Sk >= 1;
}

// Shared memory above 48 KB must be allowed per kernel.  Each kernel
// instantiation is raised once, on its first launch, to the most it can
// need (D = 128), so a launch inside CUDA-graph capture makes no
// attribute call; ``done`` is the caller's flag for that instantiation.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  *done = err == cudaSuccess;
  return err;
}

template <typename T, int DC>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int N, int Sq, int Sk, int D,
               const long long* st, int causal, float scale, cudaStream_t s) {
  static bool raised = false;  // per <T, DC>
  const size_t smem = fwd_smem(D);
  cudaError_t err = allow_smem(flash_fwd_kernel<T, DC>, fwd_smem(kMaxD), &raised);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * N);
  flash_fwd_kernel<T, DC><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, N, Sq, Sk, D,
      layout(st, 0), layout(st, 1), layout(st, 2), layout(st, 3), causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, int DC>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk,
               void* dv, int B, int N, int Sq, int Sk, int D,
               const long long* st, int causal, float scale, cudaStream_t s) {
  static bool raised_dq = false, raised_dkv = false;  // per <T, DC>
  size_t smem = dq_smem(D);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, DC>, dq_smem(kMaxD), &raised_dq);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<T, DC><<<dim3((Sq + kBQ - 1) / kBQ, B * N), kThreads,
                               smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), N, Sq, Sk, D, layout(st, 0), layout(st, 1),
      layout(st, 2), layout(st, 3), layout(st, 4), causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  smem = dkv_smem(D);
  err = allow_smem(flash_bwd_dkv_kernel<T, DC>, dkv_smem(kMaxD), &raised_dkv);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<T, DC><<<dim3((Sk + kBK - 1) / kBK, B * N), kThreads,
                                smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), N, Sq, Sk, D, layout(st, 0),
      layout(st, 1), layout(st, 2), layout(st, 3), layout(st, 5),
      layout(st, 6), causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  ``strides`` holds (batch, seq, head)
// element strides of q, k, v, out.  lse is [B, N, Sq] f32.  Launches on
// ``stream`` and returns cudaGetLastError() (0 on success); never
// synchronises.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int dtype, int B, int N, int Sq, int Sk,
                                   int D, const long long* strides,
                                   int causal, float scale, void* stream) {
  if (!shape_ok(D, Sq, Sk) || B < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool small = D <= 64;
  if (dtype == 0)
    return small ? launch_fwd<float, 4>(q, k, v, out, lse, B, N, Sq, Sk, D, strides, causal, scale, s)
                 : launch_fwd<float, 8>(q, k, v, out, lse, B, N, Sq, Sk, D, strides, causal, scale, s);
  if (dtype == 1)
    return small ? launch_fwd<__nv_bfloat16, 4>(q, k, v, out, lse, B, N, Sq, Sk, D, strides, causal, scale, s)
                 : launch_fwd<__nv_bfloat16, 8>(q, k, v, out, lse, B, N, Sq, Sk, D, strides, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Both backward passes, dq then dk/dv, on ``stream``.  ``strides`` holds
// (batch, seq, head) element strides of q, k, v, dout, dq, dk, dv; lse
// and delta are [B, N, Sq] f32.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dq, void* dk, void* dv, int dtype,
                                   int B, int N, int Sq, int Sk, int D,
                                   const long long* strides, int causal,
                                   float scale, void* stream) {
  if (!shape_ok(D, Sq, Sk) || B < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool small = D <= 64;
  if (dtype == 0)
    return small ? launch_bwd<float, 4>(q, k, v, dout, lse, delta, dq, dk, dv, B, N, Sq, Sk, D, strides, causal, scale, s)
                 : launch_bwd<float, 8>(q, k, v, dout, lse, delta, dq, dk, dv, B, N, Sq, Sk, D, strides, causal, scale, s);
  if (dtype == 1)
    return small ? launch_bwd<__nv_bfloat16, 4>(q, k, v, dout, lse, delta, dq, dk, dv, B, N, Sq, Sk, D, strides, causal, scale, s)
                 : launch_bwd<__nv_bfloat16, 8>(q, k, v, dout, lse, delta, dq, dk, dv, B, N, Sq, Sk, D, strides, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
