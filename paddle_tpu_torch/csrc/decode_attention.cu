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
// Design.  The TPU kernel runs one program per (batch, kv head) and
// walks every S block of the cache, masking positions at or past the
// length with -1e30.  A masked position adds exp(-1e30 - m) = 0 exactly,
// so walking only the valid prefix 0 .. length-1 computes the same
// function; here a sequence costs its own length, never S_max.  One
// block per (batch, kv head) holds all G <= 16 query heads of the group
// (q staged once in shared memory), and its kWarps warps split the
// prefix: warp w takes key tiles w, w + kWarps, ... of 32 positions, one
// position per lane, with its own online-softmax state (m, l and an
// output accumulator per head) in registers.  Each lane forms the G
// scores of its key from 16-byte loads of the key row; the P.V product
// reads each value row once per warp, lanes on consecutive elements.
// At the end the warps' states merge in shared memory, in warp order
// (deterministic): the largest m of each head rescales every warp's l
// and accumulator before they are summed.
//
// Bound.  At decode it is bound by device-memory bytes: each valid K and
// V row of the sequence is read once for all G heads of its group.
// Making it fast (cp.async / TMA staging of key tiles, more than one
// block per long sequence) is later work.
//
// Needs: Nq % Nkv == 0, G <= kMaxG, D % 8 == 0 and D <= kMaxD, any
// S_max >= 1, contiguous 16-byte aligned q and caches.  q, caches and
// output share one type, f32 or bf16; accumulation f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kKeys = 32;  // key positions per warp tile, one per lane
constexpr int kMaxD = 128;
constexpr int kDPerLane = kMaxD / 32;
constexpr int kMaxG = 16;
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

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
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

// G: compile-time bound on the group size (the register arrays' extent);
// the runtime group is at most G.
template <typename T, int G>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                        const T* __restrict__ v_cache,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int s_max, int num_q_heads, int num_kv_heads,
                        int head_dim, float scale) {
  const int j = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // sequence
  const int group = num_q_heads / num_kv_heads;
  const int D = head_dim;
  const int len = min(lengths[b], s_max);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // the group's G output rows [D] are contiguous in out [B, Nq, D]
  T* o = out + ((int64_t)b * num_q_heads + (int64_t)j * group) * D;
  if (len <= 0) {
    for (int e = tid; e < group * D; e += blockDim.x) store(o + e, 0.f);
    return;
  }

  __shared__ float q_s[G][kMaxD];
  __shared__ float p_s[kWarps][G][kKeys];
  __shared__ float o_s[G][kMaxD];
  __shared__ float m_s[kWarps][G];
  __shared__ float l_s[kWarps][G];

  const int vecs = D / 8;
  for (int e = tid; e < group * vecs; e += blockDim.x) {
    const int g = e / vecs;
    const int dv = (e % vecs) * 8;
    load8(q + ((int64_t)b * num_q_heads + (int64_t)j * group + g) * D + dv,
          &q_s[g][dv]);
  }
  for (int e = tid; e < G * kMaxD; e += blockDim.x) (&o_s[0][0])[e] = 0.f;
  __syncthreads();

  float m[G], l[G], acc[G][kDPerLane];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) acc[g][c] = 0.f;
  }

  const int64_t pos_stride = (int64_t)num_kv_heads * D;
  const T* kb = k_cache + ((int64_t)b * s_max * num_kv_heads + j) * D;
  const T* vb = v_cache + ((int64_t)b * s_max * num_kv_heads + j) * D;

  for (int k0 = warp * kKeys; k0 < len; k0 += kWarps * kKeys) {
    const int pos = k0 + lane;
    const bool valid = pos < len;
    const int nk = min(kKeys, len - k0);
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (valid) {
      const T* kr = kb + (int64_t)pos * pos_stride;
      for (int dv = 0; dv < D; dv += 8) {
        float kv[8];
        load8(kr + dv, kv);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (g < group) {
            const float* qq = &q_s[g][dv];
            float dot = 0.f;
#pragma unroll
            for (int i = 0; i < 8; ++i) dot += qq[i] * kv[i];
            s[g] += dot;
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < group) {  // warp-uniform
        const float sg = valid ? s[g] * scale : kNegInf;
        const float m_new = fmaxf(m[g], warp_max(sg));
        const float p = valid ? expf(sg - m_new) : 0.f;
        const float alpha = expf(m[g] - m_new);
        l[g] = l[g] * alpha + warp_sum(p);
        m[g] = m_new;
#pragma unroll
        for (int c = 0; c < kDPerLane; ++c) acc[g][c] *= alpha;
        p_s[warp][g][lane] = p;
      }
    }
    __syncwarp();
    for (int key = 0; key < nk; ++key) {
      const T* vr = vb + (int64_t)(k0 + key) * pos_stride;
      float vv[kDPerLane];
#pragma unroll
      for (int c = 0; c < kDPerLane; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? load1(vr + d) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g < group) {
          const float pk = p_s[warp][g][key];
#pragma unroll
          for (int c = 0; c < kDPerLane; ++c) acc[g][c] += pk * vv[c];
        }
      }
    }
    __syncwarp();  // p_s is rewritten by the next tile
  }

  // merge the warps' softmax states; a warp that saw no key has
  // m = -1e30 and l = 0, and its weight exp(-1e30 - M) is exactly 0
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
  }
  __syncthreads();
  float big[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    big[g] = kNegInf;
    for (int w = 0; w < kWarps; ++w) big[g] = fmaxf(big[g], m_s[w][g]);
  }
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g < group) {
          const float f = expf(m[g] - big[g]);
#pragma unroll
          for (int c = 0; c < kDPerLane; ++c) {
            const int d = lane + 32 * c;
            if (d < D) o_s[g][d] += acc[g][c] * f;
          }
        }
      }
    }
    __syncthreads();
  }
  for (int e = tid; e < group * D; e += blockDim.x) {
    const int g = e / D;
    float total = 0.f;
    for (int w = 0; w < kWarps; ++w)
      total += l_s[w][g] * expf(m_s[w][g] - big[g]);
    store(o + e, o_s[g][e % D] / fmaxf(total, 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* lengths, void* out, int batch, int s_max,
           int num_q_heads, int num_kv_heads, int head_dim, void* stream) {
  const int group = num_q_heads / num_kv_heads;
  if (batch < 1 || s_max < 1 || num_kv_heads < 1 || group < 1 ||
      group > kMaxG || num_q_heads % num_kv_heads != 0 || head_dim % 8 != 0 ||
      head_dim < 8 || head_dim > kMaxD)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(num_kv_heads, batch);
  const dim3 block(kWarps * 32);
  const float scale = 1.0f / sqrtf((float)head_dim);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k_cache);
  const T* vp = static_cast<const T*>(v_cache);
  const int* lp = static_cast<const int*>(lengths);
  T* op = static_cast<T*>(out);
#define DECODE_LAUNCH(GB)                                                  \
  decode_attention_kernel<T, GB><<<grid, block, 0, s>>>(                   \
      qp, kp, vp, lp, op, s_max, num_q_heads, num_kv_heads, head_dim, scale)
  if (group <= 1)
    DECODE_LAUNCH(1);
  else if (group <= 2)
    DECODE_LAUNCH(2);
  else if (group <= 4)
    DECODE_LAUNCH(4);
  else if (group <= 8)
    DECODE_LAUNCH(8);
  else
    DECODE_LAUNCH(16);
#undef DECODE_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, caches and output).  lengths is
// int32 [B].  Launches on ``stream`` and returns cudaGetLastError() (0 on
// success); never synchronises.
extern "C" int decode_attention(const void* q, const void* k_cache,
                                const void* v_cache, const void* lengths,
                                void* out, int dtype, int batch, int s_max,
                                int num_q_heads, int num_kv_heads,
                                int head_dim, void* stream) {
  if (dtype == 0)
    return launch<float>(q, k_cache, v_cache, lengths, out, batch, s_max,
                         num_q_heads, num_kv_heads, head_dim, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_cache, v_cache, lengths, out, batch,
                                 s_max, num_q_heads, num_kv_heads, head_dim,
                                 stream);
  return (int)cudaErrorInvalidValue;
}
