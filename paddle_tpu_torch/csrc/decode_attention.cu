// Dense-cache decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   paddle_tpu/ops/pallas/decode_attention_kernel.py ::
//   decode_attention_pallas (body _decode_kernel).
//
// What it computes.  One query token per sequence: q [B, Nq, D] against
// dense caches k_cache / v_cache [B, S_max, Nkv, D], of which the first
// lengths[b] positions are valid.  Query head h reads kv head h / G
// (G = Nq / Nkv), scores are scaled by 1/sqrt(D), the softmax runs in
// f32, and a sequence with lengths[b] <= 0 gets exact zeros.
//
// Design: split-KV flash-decoding (split_decode.cuh).  The TPU kernel
// runs one program per (batch, kv head) and walks every S block of the
// cache, masking positions at or past the length with -1e30.  A masked
// position adds exp(-1e30 - m) = 0 exactly, so walking only the valid
// prefix computes the same function.  Here the prefix is cut into chunks
// of kChunk = 128 keys and the grid is (kv head, sequence, split): block
// (j, b, s) attends the G query heads of kv head j over keys
// [s * kChunk, min((s + 1) * kChunk, length)) and writes their partial
// softmax states; a block whose chunk starts at or past the length exits
// at once.  The host sizes the split axis from S_max alone
// (ceil(S_max / kChunk)), never from the lengths on the card, so the
// launch needs no sync and a CUDA graph can capture it.  The second
// kernel, decode_combine, merges each head's live partials in split
// order and writes exact zeros for a length-0 sequence.  Nothing is
// carried between blocks and nothing is added atomically: every output
// is bitwise repeatable.
//
// Bound.  At decode it is bound by device-memory bytes: each valid K and
// V row is read once for all G heads of its group, q read and the output
// written once; the partials (f32, one [D] row per (head, split)) are
// extra traffic that stays small next to the cache rows a chunk reads.
// The grid gives a batch-8, 12-head decode hundreds of blocks instead of
// 96, and the cp.async ring keeps a stage of K/V in flight per block.
//
// Needs: Nq % Nkv == 0, G <= 16, D % 8 == 0 and D <= 128, any S_max >= 1,
// num_splits * kChunk >= S_max,
// contiguous 16-byte aligned q and caches.  q, caches and output share
// one type, f32, bf16 or f16; accumulation, the split partials and the
// softmax statistics f32.

#include "kernel_info.cuh"
#include "split_decode.cuh"

namespace {

using splitkv::kChunk;
using splitkv::kThreads;

template <typename T>
struct DecodeRows {
  const T* base;  // q row of head j * G of sequence b
  int len, part0;
  int D;
  __device__ const T* q(int i) const { return base + (int64_t)i * D; }
  __device__ int limit(int) const { return len; }
  __device__ int part(int i) const { return part0 + i; }
  __device__ T* out(int) const { return nullptr; }  // never direct
};

struct DenseKeys {
  int64_t base;  // element offset of (b, position 0, kv head j)
  int64_t stride;  // Nkv * D
  __device__ int64_t offset(int pos) const { return base + pos * stride; }
};

template <typename T, int DL>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                    const T* __restrict__ v_cache,
                    const int* __restrict__ lengths,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int s_max, int num_q_heads, int num_kv_heads, int head_dim,
                    int num_splits, float scale_log2) {
  const int j = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int len = min(lengths[b], s_max);
  const int k_begin = split * kChunk;
  if (k_begin >= len) return;  // an empty chunk: the combine skips it
  const int group = num_q_heads / num_kv_heads;
  const int part0 = b * num_q_heads + j * group;
  const DecodeRows<T> rows{q + (int64_t)part0 * head_dim, len, part0,
                           head_dim};
  const DenseKeys keys{((int64_t)b * s_max * num_kv_heads + j) * head_dim,
                       (int64_t)num_kv_heads * head_dim};
  splitkv::attend<T, T, DL>(rows, keys, k_cache, v_cache, nullptr, nullptr,
                            group, k_begin, min(len, k_begin + kChunk),
                            head_dim, scale_log2, num_splits, split, false,
                            part_acc, part_ml);
}

// grid (B, ceil(Nq * D / kThreads)): one thread per output element
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine(const float* __restrict__ part_acc,
               const float* __restrict__ part_ml,
               const int* __restrict__ lengths, T* __restrict__ out,
               int s_max, int num_q_heads, int head_dim, int num_splits) {
  const int b = blockIdx.x;
  const int e = blockIdx.y * kThreads + threadIdx.x;
  if (e >= num_q_heads * head_dim) return;
  const int h = e / head_dim;
  const int d = e - h * head_dim;
  const int len = min(lengths[b], s_max);
  T* o = out + (int64_t)b * num_q_heads * head_dim + e;
  if (len <= 0) {
    splitkv::store(o, 0.f);
    return;
  }
  const int ns = min(num_splits, (len + kChunk - 1) / kChunk);
  splitkv::merge_store(part_acc, part_ml,
                       ((int64_t)b * num_q_heads + h) * num_splits, ns,
                       head_dim, d, o);
}

// The combine's blocks a sequence: one thread per output element.
int combine_blocks(int num_q_heads, int head_dim) {
  return (num_q_heads * head_dim + kThreads - 1) / kThreads;
}

template <typename T>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* lengths, void* out, void* part_acc, void* part_ml,
           int batch, int s_max, int num_q_heads, int num_kv_heads,
           int head_dim, int num_splits, void* stream) {
  const int group = num_q_heads / num_kv_heads;
  if (batch < 1 || s_max < 1 || num_kv_heads < 1 || group < 1 ||
      group > splitkv::kRows || num_q_heads % num_kv_heads != 0 ||
      head_dim % 8 != 0 || head_dim < 8 || head_dim > splitkv::kMaxD ||
      num_splits < 1 || (int64_t)num_splits * kChunk < s_max ||
      num_splits > 65535)
    return (int)cudaErrorInvalidValue;
  const bool narrow = head_dim <= 64;
  const auto kernel =
      narrow ? decode_split_kernel<T, 2> : decode_split_kernel<T, 4>;
  static const cudaError_t attr = splitkv::allow_ring<T>(
      decode_split_kernel<T, 2>, decode_split_kernel<T, 4>);
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float scale_log2 = splitkv::kLog2e / sqrtf((float)head_dim);
  kernel<<<dim3(num_kv_heads, batch, num_splits), kThreads,
           splitkv::smem_bytes<T>(head_dim), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), static_cast<const int*>(lengths),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), s_max,
      num_q_heads, num_kv_heads, head_dim, num_splits, scale_log2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int per_b = combine_blocks(num_q_heads, head_dim);
  decode_combine<T><<<dim3(batch, per_b), kThreads, 0, s>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int*>(lengths), static_cast<T*>(out), s_max,
      num_q_heads, head_dim, num_splits);
  return (int)cudaGetLastError();
}

// The launch of :func:`launch` at these sizes, as kinfo records.
template <typename T>
int info(int batch, int num_q_heads, int num_kv_heads, int head_dim,
         int num_splits, int* out) {
  const int group = num_q_heads / num_kv_heads;
  if (batch < 1 || num_kv_heads < 1 || group < 1 ||
      group > splitkv::kRows || num_q_heads % num_kv_heads != 0 ||
      head_dim % 8 != 0 || head_dim < 8 || head_dim > splitkv::kMaxD ||
      num_splits < 1 || num_splits > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaError_t attr = splitkv::allow_ring<T>(
      decode_split_kernel<T, 2>, decode_split_kernel<T, 4>);
  if (attr != cudaSuccess) return (int)attr;
  const auto kernel = head_dim <= 64 ? decode_split_kernel<T, 2>
                                     : decode_split_kernel<T, 4>;
  out[0] = 0;
  int err = kinfo::record(kernel, dim3(num_kv_heads, batch, num_splits),
                          kThreads, splitkv::smem_bytes<T>(head_dim), out);
  if (err) return err;
  return kinfo::record(decode_combine<T>,
                       dim3(batch, combine_blocks(num_q_heads, head_dim)),
                       kThreads, 0, out);
}

}  // namespace

// The launch of decode_attention at these sizes: out[0] = 2 kernels
// (split, combine), then their kernel_info.cuh records.  Launches
// nothing.
extern "C" int decode_attention_info(int dtype, int batch, int num_q_heads,
                                     int num_kv_heads, int head_dim,
                                     int num_splits, int* out) {
  if (dtype == 0)
    return info<float>(batch, num_q_heads, num_kv_heads, head_dim,
                       num_splits, out);
  if (dtype == 1)
    return info<__nv_bfloat16>(batch, num_q_heads, num_kv_heads, head_dim,
                               num_splits, out);
  if (dtype == 2)
    return info<__half>(batch, num_q_heads, num_kv_heads, head_dim,
                        num_splits, out);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, caches and output).  lengths is
// int32 [B].  part_acc (f32 [B, Nq, num_splits, D]) and part_ml (f32
// [B, Nq, num_splits, 2]) are scratch the caller allocates; num_splits
// is the host's split plan, at least ceil(S_max / 128).  Launches the
// split kernel and the combine on ``stream`` and returns
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int decode_attention(const void* q, const void* k_cache,
                                const void* v_cache, const void* lengths,
                                void* out, void* part_acc, void* part_ml,
                                int dtype, int batch, int s_max,
                                int num_q_heads, int num_kv_heads,
                                int head_dim, int num_splits,
                                void* stream) {
  if (dtype == 0)
    return launch<float>(q, k_cache, v_cache, lengths, out, part_acc, part_ml,
                         batch, s_max, num_q_heads, num_kv_heads, head_dim,
                         num_splits, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_cache, v_cache, lengths, out, part_acc,
                                 part_ml, batch, s_max, num_q_heads,
                                 num_kv_heads, head_dim, num_splits, stream);
  if (dtype == 2)
    return launch<__half>(q, k_cache, v_cache, lengths, out, part_acc,
                          part_ml, batch, s_max, num_q_heads, num_kv_heads,
                          head_dim, num_splits, stream);
  return (int)cudaErrorInvalidValue;
}
