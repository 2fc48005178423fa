// Ragged paged causal attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   paddle_tpu/ops/pallas/ragged_attention_kernel.py ::
//   paged_ragged_attention_pallas (body _ragged_kernel, quant=False) and
//   paged_ragged_attention_quant_pallas (the same body, quant=True).
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
// Int8 pool (paged_ragged_attention_quant).  The pools hold int8 slots
// and k_scales / v_scales [NB, Nkv, bs] f32 hold one scale per (page,
// kv head, slot) -- transposed against the pages' [NB, bs, Nkv, D].  The
// kernel is the same template with an int8 pool type: each staged K/V
// row is loaded as 8 int8 values at a time (8-byte loads, so D % 8 is
// still the rule) and becomes f32 q8 * scale[page, head, slot] on its
// way into shared memory.  No dequantized pool is ever written; at
// decode the bound is 1 byte per pool element plus 4 per (slot, head).
//
// Needs: Nq % Nkv == 0, G <= kRows, D % 8 == 0 and D <= kMaxD (16-byte
// loads of f32 / bf16 rows, 8-byte loads of int8 rows), 16-byte aligned
// q / k_pages / v_pages (8-byte for int8 pools), any T >= 1 and any
// block_size >= 1.  q f32 or bf16; pools q's type or int8; accumulation
// f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// eight int8 slots of one row, dequantized by the row's scale
__device__ __forceinline__ void load8(const int8_t* src, float scale,
                                      float* dst) {
  const uint2 u = *reinterpret_cast<const uint2*>(src);
  const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = static_cast<float>(b[i]) * scale;
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

// T: q and output type.  KV: pool type, T itself or int8_t; with int8
// the scale pools are read, otherwise they are null and never touched.
template <typename T, typename KV>
__global__ void __launch_bounds__(kWarps * 32)
ragged_attention_kernel(const T* __restrict__ q, const KV* __restrict__ k_pages,
                        const KV* __restrict__ v_pages,
                        const float* __restrict__ k_scales,
                        const float* __restrict__ v_scales,
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
        const int64_t page = table[pos / block_size];
        const int64_t slot = page * block_size + pos % block_size;
        const int64_t off = (slot * num_kv_heads + j) * D + dv;
        if constexpr (std::is_same<KV, int8_t>::value) {
          const int64_t sc = (page * num_kv_heads + j) * block_size +
                             pos % block_size;
          load8(k_pages + off, k_scales[sc], &k_s[i][dv]);
          load8(v_pages + off, v_scales[sc], &v_s[i][dv]);
        } else {
          load8(k_pages + off, &k_s[i][dv]);
          load8(v_pages + off, &v_s[i][dv]);
        }
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

template <typename T, typename KV>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scales, const void* v_scales,
           const void* block_tables, const void* row_start,
           const void* row_qlen, const void* row_pos0, void* out,
           int num_tokens, int num_rows, int pages_per_row, int num_q_heads,
           int num_kv_heads, int head_dim, int block_size, void* stream) {
  const int group = num_q_heads / num_kv_heads;
  if (num_tokens < 1 || num_rows < 1 || group < 1 || group > kRows ||
      num_q_heads % num_kv_heads != 0 || head_dim % 8 != 0 ||
      head_dim > kMaxD || block_size < 1)
    return (int)cudaErrorInvalidValue;
  const int tile = kRows / group;
  const dim3 grid((num_tokens + tile - 1) / tile, num_rows, num_kv_heads);
  const dim3 block(kWarps * 32);
  const float scale = 1.0f / sqrtf((float)head_dim);
  ragged_attention_kernel<T, KV>
      <<<grid, block, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const KV*>(k_pages),
          static_cast<const KV*>(v_pages),
          static_cast<const float*>(k_scales),
          static_cast<const float*>(v_scales),
          static_cast<const int*>(block_tables),
          static_cast<const int*>(row_start),
          static_cast<const int*>(row_qlen),
          static_cast<const int*>(row_pos0), static_cast<T*>(out),
          num_q_heads, num_kv_heads, head_dim, block_size, pages_per_row,
          tile, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and output).  Launches on
// ``stream`` and returns cudaGetLastError() (0 on success); never
// synchronises.
extern "C" int paged_ragged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* row_start, const void* row_qlen,
    const void* row_pos0, void* out, int dtype, int num_tokens, int num_rows,
    int pages_per_row, int num_q_heads, int num_kv_heads, int head_dim,
    int block_size, void* stream) {
  if (dtype == 0)
    return launch<float, float>(q, k_pages, v_pages, nullptr, nullptr,
                                block_tables, row_start, row_qlen, row_pos0,
                                out, num_tokens, num_rows, pages_per_row,
                                num_q_heads, num_kv_heads, head_dim,
                                block_size, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, nullptr, nullptr, block_tables, row_start,
        row_qlen, row_pos0, out, num_tokens, num_rows, pages_per_row,
        num_q_heads, num_kv_heads, head_dim, block_size, stream);
  return (int)cudaErrorInvalidValue;
}

// The int8 pool: k_pages / v_pages int8 [NB, bs, Nkv, D], k_scales /
// v_scales f32 [NB, Nkv, bs]; dtype as above for q and the output.
extern "C" int paged_ragged_attention_quant(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_tables,
    const void* row_start, const void* row_qlen, const void* row_pos0,
    void* out, int dtype, int num_tokens, int num_rows, int pages_per_row,
    int num_q_heads, int num_kv_heads, int head_dim, int block_size,
    void* stream) {
  if (dtype == 0)
    return launch<float, int8_t>(q, k_pages, v_pages, k_scales, v_scales,
                                 block_tables, row_start, row_qlen, row_pos0,
                                 out, num_tokens, num_rows, pages_per_row,
                                 num_q_heads, num_kv_heads, head_dim,
                                 block_size, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, int8_t>(
        q, k_pages, v_pages, k_scales, v_scales, block_tables, row_start,
        row_qlen, row_pos0, out, num_tokens, num_rows, pages_per_row,
        num_q_heads, num_kv_heads, head_dim, block_size, stream);
  return (int)cudaErrorInvalidValue;
}
