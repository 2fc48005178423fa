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
// (padding, dead rows) come back as exact zeros.
//
// Design: split-KV flash-decoding (split_decode.cuh).  The TPU kernel
// walks a sequential grid (Nkv, R, P) and carries online-softmax scratch
// over the whole flat token axis from one grid step to the next; on a
// GPU blocks run concurrently and in no order, so nothing is carried
// between blocks here.  The rows' query tiles (up to tile = 16 / G
// consecutive tokens of one row, times the G query heads of one kv head)
// are numbered in row order; block (x, j * S + s) finds its tile x by a
// walk over the rows' qlen.  Block s attends tile x over the keys
// [s * kChunk, (s + 1) * kChunk) of the row's pages that the tile can see
// (kChunk = 128), gathering each key's K and V rows through the block
// table with cp.async, and writes one partial softmax state per (token,
// head, split).  A block whose chunk starts at or past its tile's
// deepest context exits at once, so the host sizes the grid from T, R
// and the table's width P alone (min(T, ceil(T / tile) + R - 1) tiles,
// S = ceil(P * bs / kChunk)) without reading the descriptors: no sync,
// capturable by a CUDA graph.  That many tiles cover disjoint rows; a block walks on to tile
// x + gridDim.x while the rows have one, so rows that overlap (outside
// the contract) lose no tile either.  The second kernel, ragged_combine,
// merges each token's partials in split order (a token at position p has
// ceil((p + 1) / kChunk) of them, each with at least one visible key) and
// writes exact zeros for every token outside the rows.  No atomics on the
// outputs: every output is bitwise repeatable.
//
// Partials.  They take (D + 2) f32 per (slot, query head, split); the
// host picks their layout by the number of slots it allocates
// (split_kv.ragged_slots).  With T slots they are indexed by token and
// every tile splits: the host gives T where that takes at most 64 MiB or
// at most R * tile slots (every step of the smoke's serving path, every
// decode step), since a short prefill chunk has too few tiles to fill the
// card (PERF.md section 6).  With fewer (a long prefill chunk at a deep
// context), only a row's last tile splits and its tokens take row slots
// (r * tile + their place in the tile; R * tile slots); every other tile
// of a row is full and lies inside the prefill chunk, where tiles alone
// give the grid its width: split 0 walks its whole context and writes
// its output directly, and the combine leaves its tokens alone.
//
// Bound.  At decode the kernel is bound by device-memory bytes: the K
// and V rows of the pages a row touches, read once per (row, kv head);
// the G query heads of a kv head share every staged row.  The split gives
// a batch-8 decode step hundreds of blocks (96 without it), and within a
// block the warps split the chunk's keys, so no single warp walks a
// 1000-key context alone.
//
// Int8 pool (paged_ragged_attention_quant).  The pools hold int8 slots
// and k_scales / v_scales [NB, Nkv, bs] f32 hold one scale per (page,
// kv head, slot) -- transposed against the pages' [NB, bs, Nkv, D].  The
// kernel is the same template with an int8 pool type: the int8 rows and
// their scales are staged as they are (8-byte copies, so D % 8 is still
// the rule) and dequantized at the operand read.  No dequantized pool is
// ever written; at decode the bound is 1 byte per pool element plus 4
// per (slot, head).
//
// Needs: Nq % Nkv == 0, G <= 16, D % 8 == 0 and D <= 128, 16-byte aligned
// q / k_pages / v_pages (8-byte for int8 pools), any T >= 1 and any
// block_size >= 1, rows whose tokens lie within [0, T), num_splits *
// kChunk >= P * bs.  Rows whose tokens overlap are outside the contract:
// a token two rows claim reads one of their results, never memory no
// kernel wrote.  q f32 or bf16; pools q's type or int8; accumulation f32.

#include <algorithm>

#include "kernel_info.cuh"
#include "split_decode.cuh"

namespace {

using splitkv::kChunk;
using splitkv::kThreads;

template <typename T>
struct TileRows {
  const T* qbase;
  T* obase;
  int tok0, group, head0, num_q_heads, D, pos1;  // pos1: position of token 0, plus 1
  int slot0;                                     // partials' slot of token 0
  __device__ int tok(int i) const { return tok0 + i / group; }
  __device__ int head(int i) const { return head0 + i % group; }
  __device__ const T* q(int i) const {
    return qbase + ((int64_t)tok(i) * num_q_heads + head(i)) * D;
  }
  __device__ T* out(int i) const {
    return obase + ((int64_t)tok(i) * num_q_heads + head(i)) * D;
  }
  __device__ int limit(int i) const { return pos1 + i / group; }
  __device__ int part(int i) const {
    return (slot0 + i / group) * num_q_heads + head(i);
  }
};

struct PagedKeys {
  const int* table;  // the row's block table
  int block_size, num_kv_heads, j, D;
  __device__ int64_t offset(int pos) const {
    const int64_t page = table[pos / block_size];
    return ((page * block_size + pos % block_size) * num_kv_heads + j) * D;
  }
  __device__ int64_t scale(int pos) const {
    const int64_t page = table[pos / block_size];
    return (page * num_kv_heads + j) * block_size + pos % block_size;
  }
};

// The rows' tiles, numbered in row order (dead rows have none): returns
// their count and, where x is below it, tile x's row r, its first token
// t0 within the row and the row's qlen.  The walk has no early exit, so
// its loads do not wait on one another.
__device__ __forceinline__ int find_tile(int x,
                                         const int* __restrict__ row_qlen,
                                         int num_rows, int tile, int& r,
                                         int& t0, int& qlen) {
  int first = 0;
#pragma unroll 4
  for (int rr = 0; rr < num_rows; ++rr) {
    const int n_q = max(row_qlen[rr], 0);
    const int n = (n_q + tile - 1) / tile;
    if (x >= first && x < first + n) {
      r = rr;
      t0 = (x - first) * tile;
      qlen = n_q;
    }
    first += n;
  }
  return first;
}

// T: q and output type.  KV: pool type, T itself or int8_t; with int8
// the scale pools are read, otherwise they are null and never touched.
template <typename T, typename KV, int DL>
__global__ void __launch_bounds__(kThreads)
ragged_split_kernel(const T* __restrict__ q, const KV* __restrict__ k_pages,
                    const KV* __restrict__ v_pages,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ row_start,
                    const int* __restrict__ row_qlen,
                    const int* __restrict__ row_pos0, T* __restrict__ out,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int num_rows, int num_q_heads, int num_kv_heads,
                    int head_dim, int block_size, int pages_per_row,
                    int tile_tokens, int per_token, int num_splits,
                    float scale_log2) {
  const int j = blockIdx.y / num_splits;
  const int split = blockIdx.y - j * num_splits;
  const int group = num_q_heads / num_kv_heads;
  int r = 0, t0 = 0, qlen = 0;
  const int tiles =
      find_tile(blockIdx.x, row_qlen, num_rows, tile_tokens, r, t0, qlen);
  for (int x = blockIdx.x; x < tiles; x += gridDim.x) {
    if (x != (int)blockIdx.x) {  // only where rows overlap
      find_tile(x, row_qlen, num_rows, tile_tokens, r, t0, qlen);
      __syncthreads();  // the previous tile's shared memory is free
    }
    const int pos0 = row_pos0[r];
    const int nt = min(tile_tokens, qlen - t0);
    const int kv_len = pos0 + t0 + nt;      // deepest context of the tile
    // every tile splits where the partials are per token, else only a
    // row's last tile
    const bool splits = per_token || t0 + nt == qlen;
    const int k_begin = splits ? split * kChunk : 0;
    if (splits ? k_begin >= kv_len : split != 0) continue;  // nothing to do
    const int tok0 = row_start[r] + t0;
    const TileRows<T> rows{q,           out,
                           tok0,        group,
                           j * group,   num_q_heads,
                           head_dim,    pos0 + t0 + 1,
                           per_token ? tok0 : r * tile_tokens};
    const PagedKeys keys{block_tables + (int64_t)r * pages_per_row,
                         block_size, num_kv_heads, j, head_dim};
    // a full tile with no context (pos0 < 0) stages key 0 and sees none
    const int k_end =
        splits ? min(kv_len, k_begin + kChunk) : max(kv_len, 1);
    splitkv::attend<T, KV, DL>(rows, keys, k_pages, v_pages, k_scales,
                               v_scales, nt * group, k_begin, k_end, head_dim,
                               scale_log2, num_splits, split, !splits,
                               part_acc, part_ml);
  }
}

// grid (T, ceil(Nq * D / kThreads)): one thread per output element of a
// token.  A token of a split tile merges its partials; a token outside
// every row gets exact zeros; a full tile's token where only last tiles
// split was written by the split kernel and is left alone.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ragged_combine(const float* __restrict__ part_acc,
               const float* __restrict__ part_ml,
               const int* __restrict__ row_start,
               const int* __restrict__ row_qlen,
               const int* __restrict__ row_pos0, T* __restrict__ out,
               int num_rows, int num_q_heads, int head_dim, int tile_tokens,
               int per_token, int num_splits) {
  __shared__ int owner_s;  // the row that owns token t (the last, if rows overlap)
  const int t = blockIdx.x;
  if (threadIdx.x == 0) owner_s = -1;
  __syncthreads();
  for (int r = threadIdx.x; r < num_rows; r += kThreads) {
    const int i = t - row_start[r];
    if (i >= 0 && i < row_qlen[r]) atomicMax(&owner_s, r);
  }
  __syncthreads();
  const int r = owner_s;
  const int e = blockIdx.y * kThreads + threadIdx.x;
  if (e >= num_q_heads * head_dim) return;
  T* o = out + (int64_t)t * num_q_heads * head_dim + e;
  if (r < 0) {
    splitkv::store(o, 0.f);
    return;
  }
  const int i = t - row_start[r];
  const int last0 = (row_qlen[r] - 1) / tile_tokens * tile_tokens;
  if (!per_token && i < last0) return;  // a full tile's token
  const int ctx = row_pos0[r] + i + 1;
  if (ctx <= 0) {
    splitkv::store(o, 0.f);
    return;
  }
  const int h = e / head_dim;
  const int slot = per_token ? t : r * tile_tokens + (i - last0);
  const int ns = min(num_splits, (ctx + kChunk - 1) / kChunk);
  splitkv::merge_store(part_acc, part_ml,
                       ((int64_t)slot * num_q_heads + h) * num_splits, ns,
                       head_dim, e - h * head_dim, o);
}

// The split kernel's tiles: every tile holds a token, so disjoint rows
// have at most min(T, ceil(T / tile) + R - 1) tiles between them.
int split_tiles(int num_tokens, int num_rows, int tile) {
  return (int)std::min<int64_t>(
      num_tokens, (num_tokens + tile - 1) / tile + num_rows - 1);
}

// The combine's blocks a token: one thread per output element.
int combine_blocks(int num_q_heads, int head_dim) {
  return (num_q_heads * head_dim + kThreads - 1) / kThreads;
}

template <typename T, typename KV>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scales, const void* v_scales,
           const void* block_tables, const void* row_start,
           const void* row_qlen, const void* row_pos0, void* out,
           void* part_acc, void* part_ml, int num_tokens, int num_rows,
           int pages_per_row, int num_q_heads, int num_kv_heads,
           int head_dim, int block_size, int num_splits, int num_slots,
           void* stream) {
  const int group = num_q_heads / num_kv_heads;
  if (num_tokens < 1 || num_rows < 1 || group < 1 ||
      group > splitkv::kRows || num_q_heads % num_kv_heads != 0 ||
      head_dim % 8 != 0 || head_dim < 8 || head_dim > splitkv::kMaxD ||
      block_size < 1 || pages_per_row < 1 || num_splits < 1 ||
      (int64_t)num_splits * kChunk < (int64_t)pages_per_row * block_size ||
      (int64_t)num_splits * num_kv_heads > 65535 ||
      (num_slots < num_tokens &&
       (int64_t)num_slots < (int64_t)num_rows * (splitkv::kRows / group)))
    return (int)cudaErrorInvalidValue;
  const auto kernel = head_dim <= 64 ? ragged_split_kernel<T, KV, 2>
                                     : ragged_split_kernel<T, KV, 4>;
  static const cudaError_t attr = splitkv::allow_ring<KV>(
      ragged_split_kernel<T, KV, 2>, ragged_split_kernel<T, KV, 4>);
  if (attr != cudaSuccess) return (int)attr;
  const int tile = splitkv::kRows / group;
  // the partials' layout: per token, or per row slot (see "Partials")
  const int per_token = num_slots >= num_tokens;
  const int tiles = split_tiles(num_tokens, num_rows, tile);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float scale_log2 = splitkv::kLog2e / sqrtf((float)head_dim);
  kernel<<<dim3(tiles, num_kv_heads * num_splits), kThreads,
           splitkv::smem_bytes<KV>(head_dim), s>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_pages),
      static_cast<const KV*>(v_pages), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales),
      static_cast<const int*>(block_tables),
      static_cast<const int*>(row_start), static_cast<const int*>(row_qlen),
      static_cast<const int*>(row_pos0), static_cast<T*>(out),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), num_rows,
      num_q_heads, num_kv_heads, head_dim, block_size, pages_per_row, tile,
      per_token, num_splits, scale_log2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int per_t = combine_blocks(num_q_heads, head_dim);
  ragged_combine<T><<<dim3(num_tokens, per_t), kThreads, 0, s>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int*>(row_start), static_cast<const int*>(row_qlen),
      static_cast<const int*>(row_pos0), static_cast<T*>(out), num_rows,
      num_q_heads, head_dim, tile, per_token, num_splits);
  return (int)cudaGetLastError();
}

// The launch of :func:`launch` at these sizes, as kinfo records.
template <typename T, typename KV>
int info(int num_tokens, int num_rows, int num_q_heads, int num_kv_heads,
         int head_dim, int num_splits, int* out) {
  const int group = num_q_heads / num_kv_heads;
  if (num_tokens < 1 || num_rows < 1 || group < 1 ||
      group > splitkv::kRows || num_q_heads % num_kv_heads != 0 ||
      head_dim % 8 != 0 || head_dim < 8 || head_dim > splitkv::kMaxD ||
      num_splits < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t attr = splitkv::allow_ring<KV>(
      ragged_split_kernel<T, KV, 2>, ragged_split_kernel<T, KV, 4>);
  if (attr != cudaSuccess) return (int)attr;
  const auto kernel = head_dim <= 64 ? ragged_split_kernel<T, KV, 2>
                                     : ragged_split_kernel<T, KV, 4>;
  const int tile = splitkv::kRows / group;
  out[0] = 0;
  int err = kinfo::record(
      kernel, dim3(split_tiles(num_tokens, num_rows, tile),
                   num_kv_heads * num_splits),
      kThreads, splitkv::smem_bytes<KV>(head_dim), out);
  if (err) return err;
  return kinfo::record(
      ragged_combine<T>,
      dim3(num_tokens, combine_blocks(num_q_heads, head_dim)), kThreads, 0,
      out);
}

}  // namespace

// The launch of paged_ragged_attention (quant 0) or ..._quant (quant 1)
// at these sizes: out[0] = 2 kernels (split, combine), then their
// kernel_info.cuh records.  Launches nothing.
extern "C" int paged_ragged_attention_info(int quant, int dtype,
                                           int num_tokens, int num_rows,
                                           int num_q_heads, int num_kv_heads,
                                           int head_dim, int num_splits,
                                           int* out) {
  if (dtype == 0 && !quant)
    return info<float, float>(num_tokens, num_rows, num_q_heads,
                              num_kv_heads, head_dim, num_splits, out);
  if (dtype == 1 && !quant)
    return info<__nv_bfloat16, __nv_bfloat16>(
        num_tokens, num_rows, num_q_heads, num_kv_heads, head_dim,
        num_splits, out);
  if (dtype == 0 && quant)
    return info<float, int8_t>(num_tokens, num_rows, num_q_heads,
                               num_kv_heads, head_dim, num_splits, out);
  if (dtype == 1 && quant)
    return info<__nv_bfloat16, int8_t>(num_tokens, num_rows, num_q_heads,
                                       num_kv_heads, head_dim, num_splits,
                                       out);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16 (q, pools and output).  part_acc (f32
// [slots, Nq, num_splits, D]) and part_ml (f32 [slots, Nq, num_splits,
// 2]) are scratch the caller allocates, num_slots >= T or >= R * (16 /
// G) of them (see "Partials" above); num_splits is the host's split plan,
// at least ceil(P * bs / 128).
// Launches the split kernel and the combine on ``stream`` and returns
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int paged_ragged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* row_start, const void* row_qlen,
    const void* row_pos0, void* out, void* part_acc, void* part_ml,
    int dtype, int num_tokens, int num_rows, int pages_per_row,
    int num_q_heads, int num_kv_heads, int head_dim, int block_size,
    int num_splits, int num_slots, void* stream) {
  if (dtype == 0)
    return launch<float, float>(
        q, k_pages, v_pages, nullptr, nullptr, block_tables, row_start,
        row_qlen, row_pos0, out, part_acc, part_ml, num_tokens, num_rows,
        pages_per_row, num_q_heads, num_kv_heads, head_dim, block_size,
        num_splits, num_slots, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, nullptr, nullptr, block_tables, row_start,
        row_qlen, row_pos0, out, part_acc, part_ml, num_tokens, num_rows,
        pages_per_row, num_q_heads, num_kv_heads, head_dim, block_size,
        num_splits, num_slots, stream);
  return (int)cudaErrorInvalidValue;
}

// The int8 pool: k_pages / v_pages int8 [NB, bs, Nkv, D], k_scales /
// v_scales f32 [NB, Nkv, bs]; dtype, scratch and plan as above.
extern "C" int paged_ragged_attention_quant(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_tables,
    const void* row_start, const void* row_qlen, const void* row_pos0,
    void* out, void* part_acc, void* part_ml, int dtype, int num_tokens,
    int num_rows, int pages_per_row, int num_q_heads, int num_kv_heads,
    int head_dim, int block_size, int num_splits, int num_slots,
    void* stream) {
  if (dtype == 0)
    return launch<float, int8_t>(
        q, k_pages, v_pages, k_scales, v_scales, block_tables, row_start,
        row_qlen, row_pos0, out, part_acc, part_ml, num_tokens, num_rows,
        pages_per_row, num_q_heads, num_kv_heads, head_dim, block_size,
        num_splits, num_slots, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, int8_t>(
        q, k_pages, v_pages, k_scales, v_scales, block_tables, row_start,
        row_qlen, row_pos0, out, part_acc, part_ml, num_tokens, num_rows,
        pages_per_row, num_q_heads, num_kv_heads, head_dim, block_size,
        num_splits, num_slots, stream);
  return (int)cudaErrorInvalidValue;
}
