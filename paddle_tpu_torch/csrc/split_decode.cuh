// Split-KV flash-decoding: the block body shared by the decode-attention
// kernels (decode_attention.cu, B6; ragged_attention.cu, B1 and B5).
//
// A block attends up to kRows query rows (token x head of one kv head)
// over one chunk [k_begin, k_end) of their keys.  A split block writes,
// per row, a partial softmax state: m (the running maximum, in log2
// units), l (the sum of 2^(s - m)) and the unnormalised output sum acc
// [D], all f32; a second kernel merges a row's partials in split order
// (merge_store), so every output is bitwise repeatable: no atomics, no
// state carried from one block to another.  A direct block (a ragged
// prefill tile, which walks its whole context in one block) writes the
// normalised output itself.
//
// Keys per split: kChunk = 128 for both kernels, chosen by timing 64,
// 128, 256 and 512 on the H100 at the smoke's table, decode and mixed
// shapes (PERF.md section 6): 128 was at or near the best on every shape
// and the best on the mixed step, where longer chunks leave too few
// blocks and shorter ones too many partials.
//
// Inside the block.  The chunk streams through shared memory in stages
// of kStageKeys keys, K and V rows (and, for an int8 pool, their f32
// scales) copied by cp.async into a two-stage ring: stage st + 1 is in
// flight while stage st is read.  Neighbouring threads copy neighbouring
// 16-byte pieces of a row (8-byte pieces for int8 rows), so one bf16
// D = 64 row is 8 threads; rows are padded by 16 bytes against bank
// conflicts.  A stage is kWarps sub-tiles of kSubKeys keys.  With fewer
// rows than warps (every decode step) the warps split the keys: warp w
// reads sub-tile w of every stage for all rows, and the warps' states
// merge in shared memory in warp order at the end.  Otherwise (a prefill
// tile) warp w owns rows w, w + kWarps, ... and reads every sub-tile.
// In a sub-tile two lanes share a key: each forms half of the D-long
// Q.K dot product with 4-element vector reads of shared memory for every
// row the warp holds, one shuffle adds the halves; one online-softmax
// update a row covers all the keys the warp read in the stage.  P.V
// takes p from shared memory, one float4 broadcast a key for up to four
// rows, and reads each value row once per warp, 2 or 4 consecutive
// elements a lane.  A warp's rows are a template parameter (1, 3 or 4),
// rows past the block's count run masked, so the key loop has no branch
// on them and the rows' chains interleave.  Scores and the softmax stay in f32, with 1/sqrt(D) * log2e
// folded into one scale and exp2f.  An int8 row is dequantized at the
// operand read: its dot product is multiplied by the slot's K scale, and
// each p by the slot's V scale; no dequantized pool is ever written.
//
// Needs D % 8 == 0 and D <= kMaxD, rows 16-byte aligned (8 for int8),
// k_begin < k_end, and dynamic shared memory of smem_bytes<KV>(D)
// (allow_ring raises the limit past 48 KB).  A row whose key limit is
// <= 0 sees no key: its partials hold m = -1e30, l = 0, and a direct
// block writes it as exact zeros.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace splitkv {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;   // query rows per block
constexpr int kSubKeys = 16;                   // keys of a sub-tile, 2 lanes a key
constexpr int kStageKeys = kWarps * kSubKeys;  // keys of one ring stage
constexpr int kMaxD = 128;
constexpr int kChunk = 128;                    // keys per split (see above)
static_assert(kChunk % kStageKeys == 0, "a split is whole ring stages");
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename KV>
__host__ __device__ constexpr int row_bytes(int d) {
  return d * (int)sizeof(KV) + 16;
}

template <typename KV>
__host__ __device__ constexpr int stage_bytes(int d) {
  return 2 * kStageKeys * row_bytes<KV>(d) +
         (std::is_same<KV, int8_t>::value ? 2 * kStageKeys * 4 : 0);
}

// the two-stage ring of K / V stages
template <typename KV>
__host__ __device__ constexpr int ring_bytes(int d) {
  return 2 * stage_bytes<KV>(d);
}

// dynamic shared memory of one block: the ring, q of the block's rows in
// f32 [kRows][D], and each warp's p of a stage's keys, one float4 (up to
// four rows) a key
template <typename KV>
__host__ __device__ constexpr int smem_bytes(int d) {
  return ring_bytes<KV>(d) + kRows * d * 4 + kWarps * kStageKeys * 16;
}

// lets both instantiations (DL 2 and 4) of a split kernel take the
// largest ring, once per process
template <typename KV, typename K>
cudaError_t allow_ring(K narrow, K wide) {
  cudaError_t err = cudaFuncSetAttribute(
      narrow, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<KV>(kMaxD));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wide,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<KV>(kMaxD));
  return err;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half(x);
}

// four consecutive elements of a shared row as f32
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
__device__ __forceinline__ void load4(const __half* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
__device__ __forceinline__ void load4(const int8_t* p, float* o) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  o[0] = (float)c.x; o[1] = (float)c.y; o[2] = (float)c.z; o[3] = (float)c.w;
}

// N = 2 or 4 consecutive elements of a shared row as f32
template <int N>
__device__ __forceinline__ void load_n(const float* p, float* o) {
  if constexpr (N == 4) {
    load4(p, o);
  } else {
    const float2 a = *reinterpret_cast<const float2*>(p);
    o[0] = a.x; o[1] = a.y;
  }
}
template <int N>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p, float* o) {
  if constexpr (N == 4) {
    load4(p, o);
  } else {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = a.x; o[1] = a.y;
  }
}
template <int N>
__device__ __forceinline__ void load_n(const __half* p, float* o) {
  if constexpr (N == 4) {
    load4(p, o);
  } else {
    const float2 a = __half22float2(*reinterpret_cast<const __half2*>(p));
    o[0] = a.x; o[1] = a.y;
  }
}
template <int N>
__device__ __forceinline__ void load_n(const int8_t* p, float* o) {
  if constexpr (N == 4) {
    load4(p, o);
  } else {
    const char2 c = *reinterpret_cast<const char2*>(p);
    o[0] = (float)c.x; o[1] = (float)c.y;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// N bytes global -> shared, or N zero bytes where ``ok`` is false (the
// source is then not read)
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool ok) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(N), "r"(ok ? N : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// sum over each half-warp (lanes 0-15 and 16-31 hold the same 16 keys)
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One stage of K / V rows (and int8 scales) of keys [base, base +
// kStageKeys) into ring slot ``slot``, cp.async, one commit group; keys
// at or past k_end are zero-filled and never read from the pools.
template <typename KV, class Keys>
__device__ __forceinline__ void issue_stage(
    const Keys& keys, const KV* __restrict__ k_pool,
    const KV* __restrict__ v_pool, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, unsigned char* slot, int base,
    int k_end, int D) {
  constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  constexpr int kPiece = kInt8 ? 8 : 16;
  const int rb = row_bytes<KV>(D);
  const int pieces = D * (int)sizeof(KV) / kPiece;  // per row
  unsigned char* vb = slot + kStageKeys * rb;
  for (int e = threadIdx.x; e < kStageKeys * pieces; e += kThreads) {
    const int key = e / pieces;
    const int pc = e - key * pieces;
    const int pos = base + key;
    const bool ok = pos < k_end;
    const int64_t off = ok ? keys.offset(pos) : 0;
    const int dst = key * rb + pc * kPiece;
    cp_async<kPiece>(smem_u32(slot + dst),
                     reinterpret_cast<const char*>(k_pool + off) + pc * kPiece,
                     ok);
    cp_async<kPiece>(smem_u32(vb + dst),
                     reinterpret_cast<const char*>(v_pool + off) + pc * kPiece,
                     ok);
  }
  if constexpr (kInt8) {
    float* ks = reinterpret_cast<float*>(vb + kStageKeys * rb);
    for (int e = threadIdx.x; e < kStageKeys; e += kThreads) {
      const int pos = base + e;
      const bool ok = pos < k_end;
      const int64_t si = ok ? keys.scale(pos) : 0;
      cp_async<4>(smem_u32(ks + e), k_scales + si, ok);
      cp_async<4>(smem_u32(ks + kStageKeys + e), v_scales + si, ok);
    }
  }
  cp_async_commit();
}

// The block's key loop for NR rows a warp.  kSplit: the warps split the
// keys (warp w reads 16-key group w of every stage, rows 0 .. NR - 1);
// otherwise warp w owns rows w + kWarps * r and reads the whole stage.
// Rows at or past nrows run masked (limit 0, never written), so the loop
// has no branch on the row count and the rows' chains interleave.
// direct: write each row's normalised output acc / l (0 where l = 0) in
// T to rows.out(i), instead of its partial state.
template <typename T, typename KV, int DL, int NR, bool kSplit, class Rows,
          class Keys>
__device__ __forceinline__ void attend_rows(
    const Rows& rows, const Keys& keys, const KV* __restrict__ k_pool,
    const KV* __restrict__ v_pool, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, int nrows, int k_begin, int k_end,
    int D, float scale_log2, int num_splits, int split, bool direct,
    float* __restrict__ part_acc, float* __restrict__ part_ml,
    const float* q_s, float4* p_s, const int* limit_s,
    float (*m_w)[kWarps], float (*l_w)[kWarps]) {
  constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  constexpr int KG = kSplit ? 1 : kWarps;  // 16-key groups a warp reads a stage
  extern __shared__ __align__(16) unsigned char ring[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rb = row_bytes<KV>(D);
  const int sb = stage_bytes<KV>(D);
  const int nstages = (k_end - k_begin + kStageKeys - 1) / kStageKeys;
  const int kk = lane & 15;  // this lane's key in a group; two lanes a key
  const int half = lane >> 4;

  int row[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) row[r] = kSplit ? r : warp + r * kWarps;
  float m[NR], l[NR], acc[NR][DL];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DL; ++c) acc[r][c] = 0.f;
  }

  for (int st = 0; st < nstages; ++st) {
    if (st + 1 < nstages) {
      issue_stage<KV>(keys, k_pool, v_pool, k_scales, v_scales,
                      ring + ((st + 1) & 1) * sb,
                      k_begin + (st + 1) * kStageKeys, k_end, D);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage st (and q_s, limit_s) visible to every warp
    const unsigned char* kb = ring + (st & 1) * sb;
    const unsigned char* vb = kb + kStageKeys * rb;
    const float* ks = reinterpret_cast<const float*>(vb + kStageKeys * rb);
    const int base = k_begin + st * kStageKeys;

    // Q.K: this lane pair's key of each group against every row
    float p[KG][NR];
    bool vis[KG][NR];
#pragma unroll
    for (int u = 0; u < KG; ++u) {
      const int key = (kSplit ? warp : u) * kSubKeys + kk;
      const KV* krow = reinterpret_cast<const KV*>(kb + key * rb);
      float dot[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) dot[r] = 0.f;
      for (int g = half * 4; g < D; g += 8) {
        float kv[4];
        load4(krow + g, kv);
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const float4 qq =
              *reinterpret_cast<const float4*>(q_s + row[r] * D + g);
          dot[r] += qq.x * kv[0] + qq.y * kv[1] + qq.z * kv[2] + qq.w * kv[3];
        }
      }
      const float ksc = kInt8 ? ks[key] : 1.f;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 16);
        vis[u][r] = base + key < limit_s[row[r]];
        p[u][r] = vis[u][r] ? dot[r] * ksc * scale_log2 : kNegInf;
      }
    }
    // online softmax over the stage's keys, one update a row
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      float mx = p[0][r];
#pragma unroll
      for (int u = 1; u < KG; ++u) mx = fmaxf(mx, p[u][r]);
      const float m_new = fmaxf(m[r], warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < KG; ++u) {
        p[u][r] = vis[u][r] ? exp2f(p[u][r] - m_new) : 0.f;
        sum += p[u][r];
      }
      const float alpha = exp2f(m[r] - m_new);
      l[r] = l[r] * alpha + half_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DL; ++c) acc[r][c] *= alpha;
    }
    // P.V: p through shared memory, a float4 of the rows a key, read as
    // one broadcast; every value row of the groups once a warp, DL
    // consecutive elements a lane; rows past k_end are zero-filled and
    // their p is 0
    float4* pw = p_s + warp * kStageKeys;
    if (half == 0) {
#pragma unroll
      for (int u = 0; u < KG; ++u) {
        float pr[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int r = 0; r < NR; ++r) pr[r] = p[u][r];
        pw[u * kSubKeys + kk] = make_float4(pr[0], pr[1], pr[2], pr[3]);
      }
    }
    __syncwarp();
    const int d0 = DL * lane;
#pragma unroll
    for (int u = 0; u < KG; ++u) {
      const int grp = (kSplit ? warp : u) * kSubKeys;
#pragma unroll
      for (int key = 0; key < kSubKeys; ++key) {
        const float4 pk = pw[u * kSubKeys + key];
        const float pr[4] = {pk.x, pk.y, pk.z, pk.w};
        float v[DL];
        if (d0 < D) {
          load_n<DL>(reinterpret_cast<const KV*>(vb + (grp + key) * rb) + d0, v);
        } else {
#pragma unroll
          for (int c = 0; c < DL; ++c) v[c] = 0.f;
        }
        if constexpr (kInt8) {
          const float vsc = ks[kStageKeys + grp + key];
#pragma unroll
          for (int c = 0; c < DL; ++c) v[c] *= vsc;
        }
#pragma unroll
        for (int r = 0; r < NR; ++r) {
#pragma unroll
          for (int c = 0; c < DL; ++c) acc[r][c] += pr[r] * v[c];
        }
      }
    }
    __syncthreads();  // every warp is done with this slot
  }

  if (kSplit) {
    // merge the warps' states in warp order; the ring is free now.  A
    // warp that saw no visible key has m = -1e30, l = 0, and its weight
    // 2^(-1e30 - M) is exactly 0 wherever another warp saw one
    float* o_w = reinterpret_cast<float*>(ring);  // [kWarps][NR][D]
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (lane == 0) {
        m_w[warp][r] = m[r];
        l_w[warp][r] = l[r];
      }
#pragma unroll
      for (int c = 0; c < DL; ++c) {
        const int d = DL * lane + c;
        if (d < D) o_w[(warp * NR + r) * D + d] = acc[r][c];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nrows * D; e += kThreads) {
      const int i = e / D;
      const int d = e - i * D;
      float big = kNegInf;
      for (int w = 0; w < kWarps; ++w) big = fmaxf(big, m_w[w][i]);
      float o = 0.f, tot = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float f = exp2f(m_w[w][i] - big);
        o += o_w[(w * NR + i) * D + d] * f;
        tot += l_w[w][i] * f;
      }
      if (direct) {
        store(rows.out(i) + d, tot > 0.f ? o / tot : 0.f);
        continue;
      }
      const int64_t pi = (int64_t)rows.part(i) * num_splits + split;
      part_acc[pi * D + d] = o;
      if (d == 0) {
        part_ml[2 * pi] = big;
        part_ml[2 * pi + 1] = tot;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (row[r] < nrows && direct) {
        T* o = rows.out(row[r]);
#pragma unroll
        for (int c = 0; c < DL; ++c) {
          const int d = DL * lane + c;
          if (d < D) store(o + d, l[r] > 0.f ? acc[r][c] / l[r] : 0.f);
        }
      } else if (row[r] < nrows) {
        const int64_t pi = (int64_t)rows.part(row[r]) * num_splits + split;
#pragma unroll
        for (int c = 0; c < DL; ++c) {
          const int d = DL * lane + c;
          if (d < D) part_acc[pi * D + d] = acc[r][c];
        }
        if (lane == 0) {
          part_ml[2 * pi] = m[r];
          part_ml[2 * pi + 1] = l[r];
        }
      }
    }
  }
}

// Rows: q(i) -> const T* row of query row i; limit(i) -> keys < limit
// are visible to row i; part(i) -> the row's index in the partials;
// out(i) -> T* output row of query row i (read only where ``direct``).
// Keys: offset(pos) -> element offset of key pos's K / V row in the
// pools; scale(pos) -> index of its scale (int8 pools only).
// Partials: part_ml [rows_total, num_splits, 2] (m, l) and part_acc
// [rows_total, num_splits, D].  DL: output elements a lane holds,
// ceil(D / 32) rounded up to 2 or 4 (D <= 64 or D <= 128).
template <typename T, typename KV, int DL, class Rows, class Keys>
__device__ __forceinline__ void attend(
    const Rows& rows, const Keys& keys, const KV* __restrict__ k_pool,
    const KV* __restrict__ v_pool, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, int nrows, int k_begin, int k_end,
    int D, float scale_log2, int num_splits, int split, bool direct,
    float* __restrict__ part_acc, float* __restrict__ part_ml) {
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ int limit_s[kRows];
  __shared__ float m_w[kWarps][kWarps], l_w[kWarps][kWarps];
  float* q_s = reinterpret_cast<float*>(ring + ring_bytes<KV>(D));
  float4* p_s = reinterpret_cast<float4*>(q_s + kRows * D);

  issue_stage<KV>(keys, k_pool, v_pool, k_scales, v_scales, ring, k_begin,
                  k_end, D);
  for (int e = threadIdx.x; e < kRows * D; e += kThreads) {
    const int i = e / D;
    q_s[e] = i < nrows ? to_f(rows.q(i)[e - i * D]) : 0.f;
  }
  for (int i = threadIdx.x; i < kRows; i += kThreads)
    limit_s[i] = i < nrows ? min(rows.limit(i), k_end) : 0;

#define SPLITKV_ROWS(NR, SPLIT)                                              \
  attend_rows<T, KV, DL, NR, SPLIT>(                                         \
      rows, keys, k_pool, v_pool, k_scales, v_scales, nrows, k_begin, k_end, \
      D, scale_log2, num_splits, split, direct, part_acc, part_ml, q_s, p_s, \
      limit_s, m_w, l_w)
  if (nrows == 1)
    SPLITKV_ROWS(1, true);
  else if (nrows < kWarps)
    SPLITKV_ROWS(kWarps - 1, true);
  else
    SPLITKV_ROWS(kRowsPerWarp, false);
#undef SPLITKV_ROWS
}

// Element d of one output row from its first ``ns`` >= 1 partials (each
// with at least one visible key), merged in split order.
template <typename T>
__device__ __forceinline__ void merge_store(const float* __restrict__ part_acc,
                                            const float* __restrict__ part_ml,
                                            int64_t p0, int ns, int D, int d,
                                            T* o) {
  float big = kNegInf;
#pragma unroll 4
  for (int s = 0; s < ns; ++s) big = fmaxf(big, part_ml[2 * (p0 + s)]);
  float acc = 0.f, tot = 0.f;
#pragma unroll 4
  for (int s = 0; s < ns; ++s) {
    const float f = exp2f(part_ml[2 * (p0 + s)] - big);
    acc += part_acc[(p0 + s) * D + d] * f;
    tot += part_ml[2 * (p0 + s) + 1] * f;
  }
  store(o, acc / tot);
}

}  // namespace splitkv
