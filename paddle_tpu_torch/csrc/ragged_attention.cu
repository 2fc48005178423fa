// Ragged paged causal attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   paddle_tpu/ops/pallas/ragged_attention_kernel.py ::
//   paged_ragged_attention_pallas (body _ragged_kernel, quant=False).
//
// What it computes.  q [T, Nq, D] holds the step's query tokens packed
// back to back; the K/V pool is [NB, bs, Nkv, D].  Row r owns tokens
// [row_start[r], row_start[r] + row_qlen[r]) of q; its token i sits at
// absolute position row_pos0[r] + i and attends over pool positions
// 0 .. row_pos0[r] + i through block_tables[r] ([R, P] page ids), with
// 1/sqrt(D) applied inside and the softmax accumulated in f32.  Query
// head h reads KV head h / G (G = Nq / Nkv).  Tokens outside every row
// are never written: the caller passes a zero-filled output, so padding
// and dead rows read back exact zeros.
//
// Design.  The TPU kernel walks a sequential grid (Nkv, R, P) and
// carries online-softmax scratch over the whole flat token axis from
// one grid step to the next; on a GPU blocks run concurrently and in no
// order, so nothing is carried between blocks here.  Each block owns one
// (query tile, row, kv head): a tile of up to kRows / G consecutive
// tokens of one row times the G query heads of that kv head.  The block
// walks that row's visible key positions in passes of kKeys, with the
// softmax state (m, l and the output accumulator) in registers, and
// writes only its own tokens.  A block whose tile starts at or past the
// row's qlen exits at once, so the grid can be sized from T on the host
// without reading the descriptors.  Key positions at or past the tile's
// deepest context are never loaded: a decode row costs its own context
// only.
//
// Bound.  At decode the kernel is bound by device-memory bytes: the K
// and V rows of the pages a row touches, read once per (row, kv head).
// The G query heads of a kv head share every staged K/V row, so a page
// row is loaded once per block for all of them.  Making it fast (TMA
// page loads, wgmma for long prefill chunks) is later work.
//
// Needs: Nq % Nkv == 0, G <= kRows, D % 8 == 0 and D <= kMaxD (16-byte
// loads), 16-byte aligned q / k_pages / v_pages, any T >= 1 and any
// block_size >= 1.  Inputs f32 or bf16, accumulation f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows (token x head) per block
constexpr int kKeys = 32;                     // key positions staged per pass, one per lane
constexpr int kMaxD = 128;
constexpr int kDPerLane = kMaxD / 32;
// padded shared row: lane i reading element d of row i hits bank (i + d) % 32
constexpr int kStride = kMaxD + 1;
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ void zero8(float* dst) {
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = 0.f;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
ragged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                        const T* __restrict__ v_pages,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ row_start,
                        const int* __restrict__ row_qlen,
                        const int* __restrict__ row_pos0, T* __restrict__ out,
                        int num_q_heads, int num_kv_heads, int head_dim,
                        int block_size, int pages_per_row, int tile_tokens,
                        float scale) {
  const int r = blockIdx.y;
  const int j = blockIdx.z;
  const int qlen = row_qlen[r];
  const int t0 = blockIdx.x * tile_tokens;  // first token of the tile, row-relative
  if (t0 >= qlen) return;                   // dead row, or a tile past the row
  const int group = num_q_heads / num_kv_heads;
  const int start = row_start[r];
  const int pos0 = row_pos0[r];
  const int nt = min(tile_tokens, qlen - t0);
  const int nrows = nt * group;             // flat row i: token i / G, head j * G + i % G
  const int kv_len = pos0 + t0 + nt;        // deepest context of the tile
  const int D = head_dim;
  const int vecs = D / 8;
  const int* table = block_tables + (int64_t)r * pages_per_row;

  __shared__ float q_s[kRows][kMaxD];
  __shared__ float k_s[kKeys][kStride];
  __shared__ float v_s[kKeys][kStride];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int e = tid; e < nrows * vecs; e += blockDim.x) {
    const int i = e / vecs;
    const int dv = (e % vecs) * 8;
    const int tok = start + t0 + i / group;
    const int head = j * group + i % group;
    load8(q + ((int64_t)tok * num_q_heads + head) * D + dv, &q_s[i][dv]);
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) acc[rr][c] = 0.f;
  }

  for (int k0 = 0; k0 < kv_len; k0 += kKeys) {
    __syncthreads();  // the previous pass's readers are done with k_s / v_s
    const int nk = min(kKeys, kv_len - k0);
    for (int e = tid; e < kKeys * vecs; e += blockDim.x) {
      const int i = e / vecs;
      const int dv = (e % vecs) * 8;
      if (i < nk) {
        const int pos = k0 + i;
        const int64_t slot =
            (int64_t)table[pos / block_size] * block_size + pos % block_size;
        const int64_t off = (slot * num_kv_heads + j) * D + dv;
        load8(k_pages + off, &k_s[i][dv]);
        load8(v_pages + off, &v_s[i][dv]);
      } else {
        zero8(&k_s[i][dv]);
        zero8(&v_s[i][dv]);
      }
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int i = warp + rr * kWarps;
      if (i < nrows) {  // warp-uniform
        const int qpos = pos0 + t0 + i / group;
        const bool visible = lane < nk && k0 + lane <= qpos;
        float s = kNegInf;
        if (visible) {
          float dot = 0.f;
          for (int d = 0; d < D; ++d) dot += q_s[i][d] * k_s[lane][d];
          s = dot * scale;
        }
        const float m_new = fmaxf(m[rr], warp_max(s));
        const float p = visible ? expf(s - m_new) : 0.f;
        const float alpha = expf(m[rr] - m_new);
        l[rr] = l[rr] * alpha + warp_sum(p);
        m[rr] = m_new;
#pragma unroll
        for (int c = 0; c < kDPerLane; ++c) acc[rr][c] *= alpha;
        for (int key = 0; key < nk; ++key) {
          const float pk = __shfl_sync(0xffffffffu, p, key);
#pragma unroll
          for (int c = 0; c < kDPerLane; ++c) {
            const int d = lane + 32 * c;
            if (d < D) acc[rr][c] += pk * v_s[key][d];
          }
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int i = warp + rr * kWarps;
    if (i < nrows) {
      const int tok = start + t0 + i / group;
      const int head = j * group + i % group;
      const float inv = 1.f / fmaxf(l[rr], 1e-30f);
      T* o = out + ((int64_t)tok * num_q_heads + head) * D;
#pragma unroll
      for (int c = 0; c < kDPerLane; ++c) {
        const int d = lane + 32 * c;
        if (d < D) store(o + d, acc[rr][c] * inv);
      }
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Launches on ``stream`` and returns
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int paged_ragged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* row_start, const void* row_qlen,
    const void* row_pos0, void* out, int dtype, int num_tokens, int num_rows,
    int pages_per_row, int num_q_heads, int num_kv_heads, int head_dim,
    int block_size, void* stream) {
  const int group = num_q_heads / num_kv_heads;
  if (num_tokens < 1 || num_rows < 1 || group < 1 || group > kRows ||
      num_q_heads % num_kv_heads != 0 || head_dim % 8 != 0 ||
      head_dim > kMaxD || block_size < 1)
    return (int)cudaErrorInvalidValue;
  const int tile = kRows / group;
  const dim3 grid((num_tokens + tile - 1) / tile, num_rows, num_kv_heads);
  const dim3 block(kWarps * 32);
  const float scale = 1.0f / sqrtf((float)head_dim);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* rs = static_cast<const int*>(row_start);
  const int* rq = static_cast<const int*>(row_qlen);
  const int* rp = static_cast<const int*>(row_pos0);
  if (dtype == 0) {
    ragged_attention_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_pages),
        static_cast<const float*>(v_pages), bt, rs, rq, rp,
        static_cast<float*>(out), num_q_heads, num_kv_heads, head_dim,
        block_size, pages_per_row, tile, scale);
  } else if (dtype == 1) {
    ragged_attention_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k_pages),
        static_cast<const __nv_bfloat16*>(v_pages), bt, rs, rq, rp,
        static_cast<__nv_bfloat16*>(out), num_q_heads, num_kv_heads,
        head_dim, block_size, pages_per_row, tile, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
