// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of
//   paddle_tpu/ops/pallas/attention_kernel.py ::
//     _flash_fwd  (body _fwd_kernel)      -> flash_attention_fwd below
//     _flash_bwd  (body _bwd_dq_kernel)   -> flash_attention_bwd, dq pass
//     _flash_bwd  (body _bwd_dkv_kernel)  -> flash_attention_bwd, dk/dv pass
// and the ``delta = rowsum(dO * O)`` that _flash_bwd leaves to XLA.
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
// plain composition.  Products, softmax and accumulators are f32.
//
// Which dtype takes which kernels.  bf16 (the O2 training path) takes the
// tensor-core kernels of namespace ``tc``; f32 takes the SIMT kernels
// (scalar f32 FMAs), because the tensor cores would read f32 as TF32,
// about three decimal digits, far outside the f32 tolerance.  The f32
// backward gets its delta from ``delta_f32_kernel``; the bf16 dq kernel
// computes delta itself, on the tensor cores (see ``flash_dq_tc``).
//
// Bound.  At GPT-124M's training shape ([8, 1024, 12, 64] bf16, causal,
// 50.4M visible (query, key) pairs) the forward does 4·D FLOPs a pair,
// 12.9 GFLOP or 0.013 ms at the 989 TFLOP/s bf16 peak, and must move
// 50 MB, 0.015 ms at 3.35 TB/s; the backward does 10·D a pair, 32.2 GFLOP
// or 0.033 ms, against 100 MB.  Both sit at the ridge: they need products
// on the tensor cores, fed from shared memory without stalls, and no
// intermediate in device memory.
//
// Design of the bf16 kernels.  A block of BM/16 warps owns BM rows of the
// resident operand (Q and dO in the forward and dq kernels, K and V in
// the dk/dv kernel), 16 rows a warp, and streams the other operand in
// tiles of BN rows through a two-stage ring in shared memory: 16-byte
// cp.async.cg copies into an XOR-swizzled bf16 layout (conflict-free
// ldmatrix), the next tile in flight while the current one computes.
// Rows past Sq/Sk and head-dim columns past D (D = 8, 24, 40, ... is
// padded to the next of 32, 64, 128) are zero-filled by the copy; columns
// past Sk and the causal diagonal are masked in registers; tiles the
// causal mask hides entirely are never loaded, and blockIdx.y is ordered
// so that the longest causal loops start first.  Every product is
// mma.sync.m16n8k16 bf16 with f32 accumulation; the resident operand's
// A fragments stay in registers (K and V in shared memory for D = 128,
// where registers run out); S = Q K^T stays in registers as C fragments
// and becomes the A fragment of the next product (the FA2 layout); the
// online softmax runs on the fragments with quad shuffles and exp2f, the
// scale applied to S in f32 after the product (1/sqrt(D) is not a power
// of two for every D, so a pre-scaled bf16 q would round).
//
// P and dS are not rounded to one bf16.  The parity rule for a bf16
// output is 1e-2·|plain| + 1e-3·rms(plain) per element against the plain
// version in f32; rounding P (forward, dV) or dS (dQ, dK) to bf16 before
// the product, as the textbook kernel and SDPA do, breaks it (chip_smoke.py
// prints SDPA's own err/limit as ``library_parity``).  So each enters as
// hi = bf16(x) and lo = bf16(x - hi), two MMAs sharing the B fragment:
// about 16 significant bits, as good as f32 under that rule.  Q, K, V and
// dO are bf16 inputs and enter exactly.  The cost is tensor-core work,
// which does not bind here: 3 tile products forward instead of 2.
//
// The backward is deterministic.  The dq kernel loops over key tiles and
// the dk/dv kernel over query tiles from the diagonal on, as the TPU split
// does; each output row is written by one block, with no atomics, so the
// gradients are bitwise repeatable.  The price is S and dP computed in
// both passes: 7 tile products (S, dP, dQ; S, dP, dV, dK) against the 5
// of one pass that adds dQ with atomics, 10 against 8 with the hi/lo
// splits.
//
// Tiles (BM x BN).  D <= 64 takes 64x64, D > 64 takes 64x32 (the register
// budget).  For D = 64 three configurations were timed at GPT-124M's
// training shape on an H100 80GB HBM3 at 700 W, in two runs of
// chip_smoke.py: 64x64 read 0.115-0.118 ms forward and 0.437-0.446 ms
// backward, 128x64 0.126-0.129 and 0.509-0.515 ms, 128x32 0.160-0.161
// and 0.553-0.555 ms.
// 64x64 wins: its 4-warp blocks give the most blocks and waste the least
// work on causal diagonal tiles.
//
// Needs: D % 8 == 0 and 8 <= D <= 128, every stride a multiple of 8
// elements and 16-byte aligned base pointers (16-byte copies), any
// Sq, Sk >= 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ============================================ f32: SIMT kernels ==
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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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
// need, so a launch inside CUDA-graph capture makes no attribute call;
// ``done`` is the caller's flag for that instantiation.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  *done = err == cudaSuccess;
  return err;
}

// delta = rowsum(dO * O) in f32 for the f32 backward: one warp per
// (b, n, row), written to [B, N, Sq].
__global__ void __launch_bounds__(256)
delta_f32_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                 float* __restrict__ delta, int N, int Sq, int D,
                 long long rows, Layout lo, Layout ldo) {
  const long long w = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (w >= rows) return;
  const int lane = threadIdx.x & 31;
  const int bn = (int)(w / Sq), r = (int)(w % Sq);
  const int b = bn / N, n = bn % N;
  const float* o = out + b * lo.b + n * lo.n + r * lo.s;
  const float* g = dout + b * ldo.b + n * ldo.n + r * ldo.s;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += o[d] * g[d];
  acc = row_sum(acc);  // each lane: the sum of its half-warp
  acc += __shfl_xor_sync(0xffffffffu, acc, 16);
  if (lane == 0) delta[w] = acc;
}

template <int DC>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int N, int Sq, int Sk, int D,
               const long long* st, int causal, float scale, cudaStream_t s) {
  static bool raised = false;  // per DC
  const size_t smem = fwd_smem(D);
  cudaError_t err = allow_smem(flash_fwd_kernel<float, DC>, fwd_smem(kMaxD), &raised);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * N);
  flash_fwd_kernel<float, DC><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, N, Sq, Sk,
      D, layout(st, 0), layout(st, 1), layout(st, 2), layout(st, 3), causal,
      scale);
  return (int)cudaGetLastError();
}

template <int DC>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const void* out, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int N, int Sq, int Sk, int D,
               const long long* st, int causal, float scale, cudaStream_t s) {
  static bool raised_dq = false, raised_dkv = false;  // per DC
  const long long rows = (long long)B * N * Sq;
  delta_f32_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const float*>(out), static_cast<const float*>(dout), delta,
      N, Sq, D, rows, layout(st, 7), layout(st, 3));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  size_t smem = dq_smem(D);
  err = allow_smem(flash_bwd_dq_kernel<float, DC>, dq_smem(kMaxD), &raised_dq);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<float, DC><<<dim3((Sq + kBQ - 1) / kBQ, B * N),
                                   kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq), N, Sq, Sk, D, layout(st, 0),
      layout(st, 1), layout(st, 2), layout(st, 3), layout(st, 4), causal,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  smem = dkv_smem(D);
  err = allow_smem(flash_bwd_dkv_kernel<float, DC>, dkv_smem(kMaxD), &raised_dkv);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<float, DC><<<dim3((Sk + kBK - 1) / kBK, B * N),
                                    kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), N, Sq, Sk, D,
      layout(st, 0), layout(st, 1), layout(st, 2), layout(st, 3),
      layout(st, 5), layout(st, 6), causal, scale);
  return (int)cudaGetLastError();
}

// ================================================= bf16: tensor cores ==
namespace tc {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where ``ok`` is false (the
// source is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as bf16 pairs hi = bf16(x, y) and lo = bf16((x, y) - hi)
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - f.x, y - f.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The C fragments of two adjacent 8-column tiles (16 rows x 16 columns of
// an f32 product) as the hi and lo A fragments of the next product, whose
// k dimension they become (the FA2 layout: no shuffle, no shared memory).
__device__ __forceinline__ void a_split(const float (&c0)[4],
                                        const float (&c1)[4],
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split2(c0[0], c0[1], hi[0], lo[0]);
  split2(c0[2], c0[3], hi[1], lo[1]);
  split2(c1[0], c1[1], hi[2], lo[2]);
  split2(c1[2], c1[3], hi[3], lo[3]);
}

// Byte offset of 16-byte chunk ``c`` of row ``r`` in a [rows][DP] bf16
// tile, XOR-swizzled so that the 8 row addresses of one ldmatrix hit 8
// distinct bank groups.
template <int DP>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int R = DP / 8;  // chunks per row: 4, 8 or 16
  const int x = R >= 8 ? (r & 7) : ((r >> 1) & 3);
  return (uint32_t)((r * R + (c ^ x)) * 16);
}

// Lane address for ldmatrix.x4 over rows [r0, r0 + 16) x chunks
// [2 kk, 2 kk + 2): with the plain load, the A fragment of a 16 x 16
// row-major operand; with .trans, the B fragments of two 8-column tiles
// of a [k][n] row-major operand (k = rows).
template <int DP>
__device__ __forceinline__ uint32_t frag_addr(int r0, int kk, int lane) {
  return swz<DP>(r0 + (lane & 15), 2 * kk + (lane >> 4));
}

// Lane address for ldmatrix.x4 of the B fragments of two 8-column tiles
// (n = rows [n0, n0 + 16)) over k = chunks [2 kk, 2 kk + 2) of an [n][k]
// row-major operand: K for Q K^T, V for dO V^T, Q or dO for the
// transposed scores of the dk/dv kernel.
template <int DP>
__device__ __forceinline__ uint32_t bn_addr(int n0, int kk, int lane) {
  return swz<DP>(n0 + (lane & 7) + ((lane >> 4) << 3),
                 2 * kk + ((lane >> 3) & 1));
}

// Async copy of rows [r0, r0 + ROWS) of one (b, n) slice into a swizzled
// [ROWS][DP] tile at shared address ``dst``; rows at or past ``rows`` and
// columns at or past D are zeros.
template <int DP, int ROWS, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* base,
                                          long long stride, int r0, int rows,
                                          int D) {
  constexpr int R = DP / 8;
  for (int e = threadIdx.x; e < ROWS * R; e += NT) {
    const int r = e / R, c = e % R;
    const bool ok = r0 + r < rows && c * 8 < D;
    cp_async16(dst + swz<DP>(r, c),
               ok ? base + (long long)(r0 + r) * stride + c * 8 : base, ok);
  }
}

// f32 (x, y) -> two bf16 at p (4-byte aligned)
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// quad (the 4 lanes that share a row of a C fragment) reductions
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// ---------------------------------------------------------------- forward --
// Grid (B * N, ceil(Sq / BM)), BM / 16 warps.  Shared: Q [BM][DP], then two
// stages of K [BN][DP] and V [BN][DP].  Lane (g = lane / 4, t = lane % 4)
// of warp w holds rows q0 + 16 w + g and + 8 of the score tile.
template <int DP, int BM, int BN>
__global__ void __launch_bounds__(BM * 2, 1)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out,
    float* __restrict__ lse, int N, int Sq, int Sk, int D, Layout lq,
    Layout lk, Layout lv, Layout lo, int causal, float scale) {
  constexpr int NT = BM * 2, KS = DP / 16, NS = BN / 8, ND = DP / 8;
  constexpr uint32_t kTile = BN * DP * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sq = smem_u32(smem);
  const uint32_t skv = sq + BM * DP * 2;

  const int bn = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest rows first
  const int b = bn / N, n = bn % N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int w0 = q0 + warp * 16, row0 = w0 + g, row1 = row0 + 8;
  const bf16* kb = k + b * lk.b + n * lk.n;
  const bf16* vb = v + b * lv.b + n * lv.n;
  const int kv_end = causal ? min(Sk, q0 + BM) : Sk;
  const int tiles = (kv_end + BN - 1) / BN;

  load_tile<DP, BM, NT>(sq, q + b * lq.b + n * lq.n, lq.s, q0, Sq, D);
  cp_async_commit();
  load_tile<DP, BN, NT>(skv, kb, lk.s, 0, Sk, D);
  load_tile<DP, BN, NT>(skv + kTile, vb, lv.s, 0, Sk, D);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) ldsm_x4(qf[kk], sq + frag_addr<DP>(warp * 16, kk, lane));

  const float c = scale * kLog2e;
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * BN;
    if (it + 1 < tiles) {
      const uint32_t nxt = skv + ((it + 1) & 1) * 2 * kTile;
      load_tile<DP, BN, NT>(nxt, kb, lk.s, k0 + BN, Sk, D);
      load_tile<DP, BN, NT>(nxt + kTile, vb, lv.s, k0 + BN, Sk, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t ks = skv + (it & 1) * 2 * kTile, vs = ks + kTile;

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t bf[4];
        ldsm_x4(bf, ks + bn_addr<DP>(j * 8, kk, lane));
        mma(s[j], qf[kk], bf[0], bf[1]);
        mma(s[j + 1], qf[kk], bf[2], bf[3]);
      }

    if (k0 + BN > Sk || (causal && k0 + BN - 1 > w0)) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + t4 * 2 + (e & 1);
          const int row = e < 2 ? row0 : row1;
          if (col >= Sk || (causal && col > row)) s[j][e] = -INFINITY;
        }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    // a row with nothing visible yet keeps m = -inf and exponent base 0
    const float base0 = mx0 == -INFINITY ? 0.f : mx0 * c;
    const float base1 = mx1 == -INFINITY ? 0.f : mx1 * c;
    const float alpha0 = exp2f(m0 * c - base0), alpha1 = exp2f(m1 * c - base1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = exp2f(fmaf(s[j][0], c, -base0));
      s[j][1] = exp2f(fmaf(s[j][1], c, -base0));
      s[j][2] = exp2f(fmaf(s[j][2], c, -base1));
      s[j][3] = exp2f(fmaf(s[j][3], c, -base1));
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = l0 * alpha0 + sum0;  // this lane's share; the quad sums at the end
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[j][0] *= alpha0;
      o[j][1] *= alpha0;
      o[j][2] *= alpha1;
      o[j][3] *= alpha1;
    }

#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t ph[4], pl[4];
      a_split(s[2 * kk], s[2 * kk + 1], ph, pl);
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        uint32_t bf[4];
        ldsm_x4_t(bf, vs + frag_addr<DP>(kk * 16, j / 2, lane));
        mma(o[j], ph, bf[0], bf[1]);
        mma(o[j], pl, bf[0], bf[1]);
        mma(o[j + 1], ph, bf[2], bf[3]);
        mma(o[j + 1], pl, bf[2], bf[3]);
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }

  l0 = fmaxf(quad_sum(l0), 1e-30f);
  l1 = fmaxf(quad_sum(l1), 1e-30f);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  bf16* ob = out + b * lo.b + n * lo.n;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int col = j * 8 + t4 * 2;
    if (col >= D) continue;
    if (row0 < Sq) store2(ob + (long long)row0 * lo.s + col, o[j][0] * inv0, o[j][1] * inv0);
    if (row1 < Sq) store2(ob + (long long)row1 * lo.s + col, o[j][2] * inv1, o[j][3] * inv1);
  }
  if (t4 == 0) {
    if (row0 < Sq) lse[(long long)bn * Sq + row0] = m0 * scale + logf(l0);
    if (row1 < Sq) lse[(long long)bn * Sq + row1] = m1 * scale + logf(l1);
  }
}

// ------------------------------------------------------------ backward dq --
// Grid (B * N, ceil(Sq / BM)).  Shared: Q, dO, O [BM][DP], then two stages
// of K [BN][DP] and V [BN][DP].  Writes delta for its rows first; the dk/dv
// kernel, next on the stream, reads it.
template <int DP, int BM, int BN>
__global__ void __launch_bounds__(BM * 2, 1)
flash_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const bf16* __restrict__ out, const float* __restrict__ lse,
          float* __restrict__ delta, bf16* __restrict__ dq, int N, int Sq,
          int Sk, int D, Layout lq, Layout lk, Layout lv, Layout ldo,
          Layout lo, Layout ldq, int causal, float scale) {
  constexpr int NT = BM * 2, KS = DP / 16, NS = BN / 8, ND = DP / 8;
  constexpr uint32_t kTile = BN * DP * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sq = smem_u32(smem);
  const uint32_t sdo = sq + BM * DP * 2;
  const uint32_t so = sdo + BM * DP * 2;
  const uint32_t skv = so + BM * DP * 2;

  const int bn = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int b = bn / N, n = bn % N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int w0 = q0 + warp * 16, row0 = w0 + g, row1 = row0 + 8;
  const bf16* kb = k + b * lk.b + n * lk.n;
  const bf16* vb = v + b * lv.b + n * lv.n;
  const bf16* dob = dout + b * ldo.b + n * ldo.n;
  const int kv_end = causal ? min(Sk, q0 + BM) : Sk;
  const int tiles = (kv_end + BN - 1) / BN;

  load_tile<DP, BM, NT>(sq, q + b * lq.b + n * lq.n, lq.s, q0, Sq, D);
  load_tile<DP, BM, NT>(sdo, dob, ldo.s, q0, Sq, D);
  load_tile<DP, BM, NT>(so, out + b * lo.b + n * lo.n, lo.s, q0, Sq, D);
  cp_async_commit();
  load_tile<DP, BN, NT>(skv, kb, lk.s, 0, Sk, D);
  load_tile<DP, BN, NT>(skv + kTile, vb, lv.s, 0, Sk, D);
  cp_async_commit();
  const float lb0 = row0 < Sq ? lse[(long long)bn * Sq + row0] * kLog2e : 0.f;
  const float lb1 = row1 < Sq ? lse[(long long)bn * Sq + row1] * kLog2e : 0.f;

  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[KS][4], gf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    ldsm_x4(qf[kk], sq + frag_addr<DP>(warp * 16, kk, lane));
    ldsm_x4(gf[kk], sdo + frag_addr<DP>(warp * 16, kk, lane));
  }

  // delta of the warp's 16 rows: the diagonal of dO O^T on the tensor
  // cores, the instruction and k order of dP = dO V^T, so that dP - delta
  // cancels exactly where O is the one visible key's V (a single key).
  // Row g's diagonal element and row g + 8's sit in lane 4 g + g / 2.
  float dl0, dl1;
  {
    float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t bf[4];
      ldsm_x4(bf, so + bn_addr<DP>(warp * 16, kk, lane));
      mma(d0, gf[kk], bf[0], bf[1]);
      mma(d1, gf[kk], bf[2], bf[3]);
    }
    const int src = 4 * g + (g >> 1);
    dl0 = __shfl_sync(kFull, (g & 1) ? d0[1] : d0[0], src);
    dl1 = __shfl_sync(kFull, (g & 1) ? d1[3] : d1[2], src);
    if (t4 == 0) {
      if (row0 < Sq) delta[(long long)bn * Sq + row0] = dl0;
      if (row1 < Sq) delta[(long long)bn * Sq + row1] = dl1;
    }
  }

  const float c = scale * kLog2e;
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * BN;
    if (it + 1 < tiles) {
      const uint32_t nxt = skv + ((it + 1) & 1) * 2 * kTile;
      load_tile<DP, BN, NT>(nxt, kb, lk.s, k0 + BN, Sk, D);
      load_tile<DP, BN, NT>(nxt + kTile, vb, lv.s, k0 + BN, Sk, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t ks = skv + (it & 1) * 2 * kTile, vs = ks + kTile;

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t bf[4];
        ldsm_x4(bf, ks + bn_addr<DP>(j * 8, kk, lane));
        mma(s[j], qf[kk], bf[0], bf[1]);
        mma(s[j + 1], qf[kk], bf[2], bf[3]);
        ldsm_x4(bf, vs + bn_addr<DP>(j * 8, kk, lane));
        mma(dp[j], gf[kk], bf[0], bf[1]);
        mma(dp[j + 1], gf[kk], bf[2], bf[3]);
      }

    const bool edge = k0 + BN > Sk || (causal && k0 + BN - 1 > w0);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + t4 * 2 + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const bool ok = !edge || (col < Sk && (!causal || col <= row));
        const float p = ok ? exp2f(fmaf(s[j][e], c, -(e < 2 ? lb0 : lb1))) : 0.f;
        s[j][e] = p * (dp[j][e] - (e < 2 ? dl0 : dl1)) * scale;  // dS
      }

#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t hi[4], lo_[4];
      a_split(s[2 * kk], s[2 * kk + 1], hi, lo_);
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        uint32_t bf[4];
        ldsm_x4_t(bf, ks + frag_addr<DP>(kk * 16, j / 2, lane));
        mma(acc[j], hi, bf[0], bf[1]);
        mma(acc[j], lo_, bf[0], bf[1]);
        mma(acc[j + 1], hi, bf[2], bf[3]);
        mma(acc[j + 1], lo_, bf[2], bf[3]);
      }
    }
    __syncthreads();
  }

  bf16* ob = dq + b * ldq.b + n * ldq.n;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int col = j * 8 + t4 * 2;
    if (col >= D) continue;
    if (row0 < Sq) store2(ob + (long long)row0 * ldq.s + col, acc[j][0], acc[j][1]);
    if (row1 < Sq) store2(ob + (long long)row1 * ldq.s + col, acc[j][2], acc[j][3]);
  }
}

// --------------------------------------------------------- backward dk/dv --
// Grid (B * N, ceil(Sk / BM)).  The block owns keys k0 .. k0 + BM; lane
// (g, t) of warp w holds keys k0 + 16 w + g and + 8 of the transposed
// scores S^T = K Q^T.  Shared: K, V [BM][DP], then two stages of Q [BN][DP],
// dO [BN][DP], lse [BN] and delta [BN] f32.  K and V fragments stay in
// registers for DP <= 64 and are read from shared memory for DP = 128.
template <int DP, int BM, int BN>
__global__ void __launch_bounds__(BM * 2, 1)
flash_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int Sq,
           int Sk, int D, Layout lq, Layout lk, Layout lv, Layout ldo,
           Layout ldk, Layout ldv, int causal, float scale) {
  constexpr int NT = BM * 2, KS = DP / 16, NS = BN / 8, ND = DP / 8;
  constexpr bool kRegs = DP <= 64;
  constexpr int KF = kRegs ? KS : 1;
  constexpr uint32_t kTile = BN * DP * 2;
  constexpr uint32_t kStage = 2 * kTile + 2 * BN * 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sk = smem_u32(smem);
  const uint32_t sv = sk + BM * DP * 2;
  const uint32_t sring = sv + BM * DP * 2;
  const float* ring = reinterpret_cast<const float*>(smem + 2 * BM * DP * 2);

  const int bn = blockIdx.x;
  const int k0 = blockIdx.y * BM;  // key tile 0 has the longest causal loop
  const int b = bn / N, n = bn % N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int w0 = k0 + warp * 16, key0 = w0 + g, key1 = key0 + 8;
  const bf16* qb = q + b * lq.b + n * lq.n;
  const bf16* gb = dout + b * ldo.b + n * ldo.n;
  const float* lseb = lse + (long long)bn * Sq;
  const float* dlb = delta + (long long)bn * Sq;
  // query tiles before this key block's diagonal see none of its keys
  const int q_begin = causal ? (k0 / BN) * BN : 0;
  const int tiles = (Sq - q_begin + BN - 1) / BN;

  auto load_stage = [&](int st, int q0) {
    const uint32_t base = sring + st * kStage;
    load_tile<DP, BN, NT>(base, qb, lq.s, q0, Sq, D);
    load_tile<DP, BN, NT>(base + kTile, gb, ldo.s, q0, Sq, D);
    for (int r = threadIdx.x; r < BN; r += NT) {
      const bool ok = q0 + r < Sq;
      cp_async4(base + 2 * kTile + r * 4, ok ? lseb + q0 + r : lseb, ok);
      cp_async4(base + 2 * kTile + (BN + r) * 4, ok ? dlb + q0 + r : dlb, ok);
    }
  };

  load_tile<DP, BM, NT>(sk, k + b * lk.b + n * lk.n, lk.s, k0, Sk, D);
  load_tile<DP, BM, NT>(sv, v + b * lv.b + n * lv.n, lv.s, k0, Sk, D);
  cp_async_commit();
  load_stage(0, q_begin);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t kf[KF][4], vf[KF][4];
  if constexpr (kRegs) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ldsm_x4(kf[kk], sk + frag_addr<DP>(warp * 16, kk, lane));
      ldsm_x4(vf[kk], sv + frag_addr<DP>(warp * 16, kk, lane));
    }
  }

  const float c = scale * kLog2e;
  float ak[ND][4], av[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[j][e] = av[j][e] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int q0 = q_begin + it * BN;
    if (it + 1 < tiles) {
      load_stage((it + 1) & 1, q0 + BN);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t qs = sring + (it & 1) * kStage, gs = qs + kTile;
    const float* lse_s = ring + (it & 1) * (kStage / 4) + 2 * kTile / 4;
    const float* dl_s = lse_s + BN;

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int x = kRegs ? kk : 0;
      if constexpr (!kRegs) {
        ldsm_x4(kf[0], sk + frag_addr<DP>(warp * 16, kk, lane));
        ldsm_x4(vf[0], sv + frag_addr<DP>(warp * 16, kk, lane));
      }
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t bf[4];
        ldsm_x4(bf, qs + bn_addr<DP>(j * 8, kk, lane));
        mma(s[j], kf[x], bf[0], bf[1]);
        mma(s[j + 1], kf[x], bf[2], bf[3]);
        ldsm_x4(bf, gs + bn_addr<DP>(j * 8, kk, lane));
        mma(dp[j], vf[x], bf[0], bf[1]);
        mma(dp[j + 1], vf[x], bf[2], bf[3]);
      }
    }

    const bool edge = q0 + BN > Sq || k0 + BM > Sk || (causal && q0 < w0 + 15);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + t4 * 2 + (e & 1);
        const int row = q0 + qc;
        const int key = e < 2 ? key0 : key1;
        const bool ok = !edge || (row < Sq && key < Sk && (!causal || row >= key));
        const float p = ok ? exp2f(fmaf(s[j][e], c, -lse_s[qc] * kLog2e)) : 0.f;
        dp[j][e] = p * (dp[j][e] - dl_s[qc]) * scale;  // dS^T
        s[j][e] = p;                                   // P^T
      }

#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t ph[4], pl[4], dh[4], dlo[4];
      a_split(s[2 * kk], s[2 * kk + 1], ph, pl);
      a_split(dp[2 * kk], dp[2 * kk + 1], dh, dlo);
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        uint32_t bf[4];
        ldsm_x4_t(bf, gs + frag_addr<DP>(kk * 16, j / 2, lane));
        mma(av[j], ph, bf[0], bf[1]);
        mma(av[j], pl, bf[0], bf[1]);
        mma(av[j + 1], ph, bf[2], bf[3]);
        mma(av[j + 1], pl, bf[2], bf[3]);
        ldsm_x4_t(bf, qs + frag_addr<DP>(kk * 16, j / 2, lane));
        mma(ak[j], dh, bf[0], bf[1]);
        mma(ak[j], dlo, bf[0], bf[1]);
        mma(ak[j + 1], dh, bf[2], bf[3]);
        mma(ak[j + 1], dlo, bf[2], bf[3]);
      }
    }
    __syncthreads();
  }

  bf16* kout = dk + b * ldk.b + n * ldk.n;
  bf16* vout = dv + b * ldv.b + n * ldv.n;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int col = j * 8 + t4 * 2;
    if (col >= D) continue;
    if (key0 < Sk) {
      store2(kout + (long long)key0 * ldk.s + col, ak[j][0], ak[j][1]);
      store2(vout + (long long)key0 * ldv.s + col, av[j][0], av[j][1]);
    }
    if (key1 < Sk) {
      store2(kout + (long long)key1 * ldk.s + col, ak[j][2], ak[j][3]);
      store2(vout + (long long)key1 * ldv.s + col, av[j][2], av[j][3]);
    }
  }
}

constexpr size_t fwd_bytes(int DP, int BM, int BN) { return 2 * DP * (BM + 4 * BN); }
constexpr size_t dq_bytes(int DP, int BM, int BN) { return 2 * DP * (3 * BM + 4 * BN); }
constexpr size_t dkv_bytes(int DP, int BM, int BN) {
  return 2 * DP * (2 * BM + 4 * BN) + 16 * BN;
}

// grid rows: (b, n) in x, row tiles in y (at most 65535 of them)
int check_grid(int S, int BM) {
  return (S + BM - 1) / BM <= 65535 ? 0 : (int)cudaErrorInvalidValue;
}

template <int DP, int BM, int BN>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int N, int Sq, int Sk, int D,
               const long long* st, int causal, float scale, cudaStream_t s) {
  static bool raised = false;  // per instantiation
  constexpr size_t smem = fwd_bytes(DP, BM, BN);
  if (int e = check_grid(Sq, BM)) return e;
  cudaError_t err = allow_smem(flash_fwd_tc<DP, BM, BN>, smem, &raised);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_tc<DP, BM, BN><<<dim3(B * N, (Sq + BM - 1) / BM), BM * 2, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, N, Sq, Sk,
      D, layout(st, 0), layout(st, 1), layout(st, 2), layout(st, 3), causal,
      scale);
  return (int)cudaGetLastError();
}

template <int DP, int BM, int BN>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const void* out, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int N, int Sq, int Sk, int D,
               const long long* st, int causal, float scale, cudaStream_t s) {
  static bool raised_dq = false, raised_dkv = false;  // per instantiation
  constexpr size_t smem_dq = dq_bytes(DP, BM, BN);
  constexpr size_t smem_dkv = dkv_bytes(DP, BM, BN);
  if (int e = check_grid(Sq, BM)) return e;
  if (int e = check_grid(Sk, BM)) return e;
  cudaError_t err = allow_smem(flash_dq_tc<DP, BM, BN>, smem_dq, &raised_dq);
  if (err != cudaSuccess) return (int)err;
  flash_dq_tc<DP, BM, BN><<<dim3(B * N, (Sq + BM - 1) / BM), BM * 2, smem_dq, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const bf16*>(out), lse, delta, static_cast<bf16*>(dq), N,
      Sq, Sk, D, layout(st, 0), layout(st, 1), layout(st, 2), layout(st, 3),
      layout(st, 7), layout(st, 4), causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(flash_dkv_tc<DP, BM, BN>, smem_dkv, &raised_dkv);
  if (err != cudaSuccess) return (int)err;
  flash_dkv_tc<DP, BM, BN><<<dim3(B * N, (Sk + BM - 1) / BM), BM * 2, smem_dkv, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), N, Sq, Sk, D,
      layout(st, 0), layout(st, 1), layout(st, 2), layout(st, 3),
      layout(st, 5), layout(st, 6), causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

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
  if (dtype == 0)
    return D <= 64 ? launch_fwd<4>(q, k, v, out, lse, B, N, Sq, Sk, D, strides, causal, scale, s)
                   : launch_fwd<8>(q, k, v, out, lse, B, N, Sq, Sk, D, strides, causal, scale, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (D <= 32) return tc::launch_fwd<32, 64, 64>(q, k, v, out, lse, B, N, Sq, Sk, D, strides, causal, scale, s);
  if (D <= 64) return tc::launch_fwd<64, 64, 64>(q, k, v, out, lse, B, N, Sq, Sk, D, strides, causal, scale, s);
  return tc::launch_fwd<128, 64, 32>(q, k, v, out, lse, B, N, Sq, Sk, D, strides, causal, scale, s);
}

// Both backward passes on ``stream``: delta = rowsum(dout * out) into
// ``delta`` ([B, N, Sq] f32 scratch), dq, then dk/dv.  ``strides`` holds
// (batch, seq, head) element strides of q, k, v, dout, dq, dk, dv, out;
// lse is [B, N, Sq] f32.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* out, const float* lse,
                                   float* delta, void* dq, void* dk,
                                   void* dv, int dtype, int B, int N, int Sq,
                                   int Sk, int D, const long long* strides,
                                   int causal, float scale, void* stream) {
  if (!shape_ok(D, Sq, Sk) || B < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return D <= 64 ? launch_bwd<4>(q, k, v, dout, out, lse, delta, dq, dk, dv, B, N, Sq, Sk, D, strides, causal, scale, s)
                   : launch_bwd<8>(q, k, v, dout, out, lse, delta, dq, dk, dv, B, N, Sq, Sk, D, strides, causal, scale, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (D <= 32) return tc::launch_bwd<32, 64, 64>(q, k, v, dout, out, lse, delta, dq, dk, dv, B, N, Sq, Sk, D, strides, causal, scale, s);
  if (D <= 64) return tc::launch_bwd<64, 64, 64>(q, k, v, dout, out, lse, delta, dq, dk, dv, B, N, Sq, Sk, D, strides, causal, scale, s);
  return tc::launch_bwd<128, 64, 32>(q, k, v, dout, out, lse, delta, dq, dk, dv, B, N, Sq, Sk, D, strides, causal, scale, s);
}
