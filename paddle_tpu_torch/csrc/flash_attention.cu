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
// Which dtype takes which kernels.  All three run on the tensor cores, in
// one design (below): bf16 and f16 (the O2 paths) in the 16-bit kernels
// ``flash_*_tc``, f32 in ``flash_*_f32``.  One TF32 product keeps about
// three decimal digits, far outside the f32 tolerance, so every f32
// product A B runs as three: each operand splits into hi = tf32(x) and
// lo = tf32(x - hi) (cvt.rna.tf32.f32: to nearest, not the hardware's
// truncation of the low 13 bits), and A B = A_lo B_hi + A_hi B_lo +
// A_hi B_hi on mma.sync.m16n8k8 TF32 with f32 accumulation.  What is left
// out, A_lo B_lo and the bits past lo, is about 2^-22 of a product, three
// orders inside the f32 limit: chip_smoke.py's f32 ``kernel_parity``
// lines hold the kernels to it, beside a control that rounds q, k, v and
// P to one TF32 part and breaks it; tests/test_torch_flash_attention.py
// holds the same split (``split_tf32``) to the JAX kernel on the CPU.
// Both dq kernels compute delta = rowsum(dO * O) for their rows.
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
// Rows past Sq/Sk and head-dim columns past D (any D up to 128 is padded
// to the next of 32, 64, 128) are zero-filled by the copy; columns
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
// Design of the f32 kernels.  The 16-bit kernels' grids, warps, masks,
// row order and softmax over split tiles.  Splitting costs 8 instructions
// an element (cvt.rna with its Inf/NaN check, twice, and a subtraction),
// so a streamed element is split once where it lands, not by each of the
// four warps that read it: a tile arrives raw (16-byte cp.async copies,
// the next tile in flight while this one computes), the block splits it
// into a hi plane and a lo plane, and the warps read their B fragments
// from the planes, no conversion left.  The resident operand is split the
// same way once (Q; Q and K in the backward passes, whose second resident
// operand, dO or V, stays raw and is split at each use: its planes would
// leave one block an SM).  Every tile has a row pitch of DP + 4 floats,
// so that both fragment reads of m16n8k8 (lane (g, t) reads row g at
// columns t and t + 4 of an [n][k] tile, or rows 2t and 2t + 1 at column g
// of a [k][n] tile) take 32 distinct banks at addresses that are the
// lane's base plus a constant; there is no ldmatrix for 32-bit elements.
// A C fragment holds columns 2t and 2t + 1 of its rows and an A fragment
// columns t and t + 4, so P and dS enter the next product with their 8
// keys relabelled (logical key t is key 2t, t + 4 is 2t + 1) and the B
// fragment reads its key rows in that order; a sum over keys does not
// depend on it.  P and dS are split in registers by the warp that owns
// them.  The blocks stream 32 rows a tile (``kBN``), which keeps two
// blocks an SM at DP 64.  An f32 product costs 3 MMAs of half the bf16
// depth: the bound is 165 TFLOP/s (495 / 3), which an mp = 2 rank's
// [2, 1024, 6, 64] causal call reaches in 0.0098 ms forward and 0.0244 ms
// backward.  Tiles, timed by ``python3 chip_smoke.py flash_f32_designs``
// on an H100 80GB HBM3 at 700 W, two runs, ms forward / backward: at the
// mp = 2 rank's shape 64x32 read 0.091 / 0.311-0.314, 64x64 0.074-0.075 /
// 0.275-0.277, 128x32 0.108 / 0.372-0.373; at BERT-base's [8, 512, 12, 64]
// 0.174-0.176 / 0.589-0.592, 0.215 / 0.843, 0.168 / 0.600; at the
// Conformer's [16, 250, 4, 36] 0.038 / 0.121-0.123, 0.050 / 0.196-0.199,
// 0.036 / 0.124-0.125.  64x64 (one block an SM) wins only where a causal
// grid's longest blocks set the time; 64x32 is kept.  cvt.rna.satfinite
// (no Inf/NaN branch) read slower, 0.097 / 0.346 at the mp = 2 rank.
//
// Any head dim.  The Pallas kernel takes every D <= 128 (its block is the
// whole head dim), so these kernels do too: 1 <= D <= 128, any Sq, Sk >= 1,
// q/k/v/dO/O read through any strides with the last dim contiguous.  A
// row of D = 36 bf16 is 72 bytes, so not every row starts on 16 bytes:
// each tensor's copy width (Layout::vw) is the widest of 16, 8, 4 and 2
// bytes that divides its base address, its strides and its row (D times
// the element size), chosen on the host.  Rows and tiles keep their
// padded layout; a copy narrower than 16 bytes fills one 16-byte chunk in
// pieces (cp.async of 8 or 4 bytes with a zero-filling source size, or,
// for 2-byte rows, plain loads and one 16-byte shared store), and chunks
// past D are stored as zeros.  The softmax scale stays 1/sqrt(D) (the
// caller's), never 1/sqrt of the padded width.  Outputs are written in
// pairs where the row is 4-byte aligned and element by element where
// not (odd D).  Every kernel has two instances: a launch whose tensors
// all take 16-byte copies at D % 8 == 0 (every contiguous or packed
// q/k/v of such a D) runs the aligned one (template V), compiled without
// the narrower copies' branches, as the kernels were before they took
// any D; every other launch runs the general one.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "kernel_info.cuh"

namespace {

constexpr int kMaxD = 128;

struct Layout {
  long long b, s, n;  // element strides of batch, sequence, head
  int vw;             // bytes a copy: the widest of 16, 8, 4, 2 aligned
};

// The (batch, seq, head) strides of tensor t of ``strides`` and its copy
// width: the widest of 16, 8, 4 and 2 bytes (at least the element size)
// dividing its address ``p``, every stride and its row of D elements.
Layout layout(const long long* strides, int t, const void* p, int D,
              int esize) {
  Layout l{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2], 16};
  const unsigned long long bits =
      (unsigned long long)reinterpret_cast<uintptr_t>(p) |
      (unsigned long long)(l.b * esize) | (unsigned long long)(l.s * esize) |
      (unsigned long long)(l.n * esize) | (unsigned long long)(D * esize);
  while (l.vw > esize && (bits & (l.vw - 1))) l.vw >>= 1;
  return l;
}

bool shape_ok(int D, int Sq, int Sk) {
  return D >= 1 && D <= kMaxD && Sq >= 1 && Sk >= 1;
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

// ========================================= bf16 and f16: tensor cores ==
namespace tc {

using bf16 = __nv_bfloat16;
using f16 = __half;

// The two 16-bit operand types: bf16 (O2 bf16) and f16 (O2 float16).  The
// kernels are the same for both; these helpers are the only places the
// type shows.
template <typename T>
struct IsF16 {
  static constexpr bool value = false;
};
template <>
struct IsF16<f16> {
  static constexpr bool value = true;
};

// f32 (x, y) rounded to a T pair, as one 32-bit word
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x, float y) {
  uint32_t u;
  if constexpr (IsF16<T>::value) {
    const __half2 h = __floats2half2_rn(x, y);
    u = *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    u = *reinterpret_cast<const uint32_t*>(&h);
  }
  return u;
}

template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  if constexpr (IsF16<T>::value)
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

template <typename T>
__device__ __forceinline__ T to_elem(float x) {
  if constexpr (std::is_same<T, float>::value)
    return x;
  else if constexpr (IsF16<T>::value)
    return __float2half_rn(x);
  else
    return __float2bfloat16(x);
}
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

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

// four 32-bit words to 16 bytes of shared memory
__device__ __forceinline__ void st_shared16(uint32_t dst, uint32_t a,
                                            uint32_t b, uint32_t c,
                                            uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(a), "r"(b), "r"(c), "r"(d)
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

// c += a (16 x 16, row) * b (16 x 8, col), T in, f32 accumulate
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if constexpr (IsF16<T>::value)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as T pairs hi = T(x, y) and lo = T((x, y) - hi)
template <typename T>
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  hi = pack2<T>(x, y);
  const float2 f = unpack2<T>(hi);
  lo = pack2<T>(x - f.x, y - f.y);
}

// The C fragments of two adjacent 8-column tiles (16 rows x 16 columns of
// an f32 product) as the hi and lo A fragments of the next product, whose
// k dimension they become (the FA2 layout: no shuffle, no shared memory).
template <typename T>
__device__ __forceinline__ void a_split(const float (&c0)[4],
                                        const float (&c1)[4],
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split2<T>(c0[0], c0[1], hi[0], lo[0]);
  split2<T>(c0[2], c0[3], hi[1], lo[1]);
  split2<T>(c1[0], c1[1], hi[2], lo[2]);
  split2<T>(c1[2], c1[3], hi[3], lo[3]);
}

// Byte offset of 16-byte chunk ``c`` of row ``r`` in a [rows][DP] 16-bit
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
// columns at or past D are zeros.  ``vw`` is the row's copy width (see
// Layout): a 16-byte chunk is one cp.async at 16, two or four at 8 or 4
// (the pieces past D zero-filled by a source size of 0), and at 2 a plain
// load of its elements and one shared store.  The pieces of a chunk past
// D read nothing; their address is the chunk's start, inside the row.
template <typename T, int DP, int ROWS, int NT, bool V>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* base,
                                          long long stride, int vw, int r0,
                                          int rows, int D) {
  constexpr int R = DP / 8;
  for (int e = threadIdx.x; e < ROWS * R; e += NT) {
    const int r = e / R, c = e % R;
    if constexpr (V) {  // 16-byte rows, D % 8 == 0: one copy a chunk
      const bool ok = r0 + r < rows && c * 8 < D;
      cp_async16(dst + swz<DP>(r, c),
                 ok ? base + (long long)(r0 + r) * stride + c * 8 : base, ok);
      continue;
    }
    const uint32_t d = dst + swz<DP>(r, c);
    const int n = r0 + r < rows ? min(8, D - c * 8) : 0;  // live elements
    if (n <= 0) {
      st_shared16(d, 0u, 0u, 0u, 0u);
      continue;
    }
    const T* src = base + (long long)(r0 + r) * stride + c * 8;
    if (vw == 16) {
      cp_async16(d, src, true);
    } else if (vw == 8) {
      cp_async8(d, src, true);
      cp_async8(d + 8, n > 4 ? src + 4 : src, n > 4);
    } else if (vw == 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        cp_async4(d + 4 * i, 2 * i < n ? src + 2 * i : src, 2 * i < n);
    } else {
      const unsigned short* h = reinterpret_cast<const unsigned short*>(src);
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = (2 * i < n ? (uint32_t)h[2 * i] : 0u) |
               ((2 * i + 1 < n ? (uint32_t)h[2 * i + 1] : 0u) << 16);
      st_shared16(d, w[0], w[1], w[2], w[3]);
    }
  }
}

// f32 (x, y) -> T at columns col, col + 1 of the row at p: a pair where
// both are inside D and p + col is aligned to the pair (always, under V),
// else one by one
template <typename T, bool V>
__device__ __forceinline__ void store2(T* p, int col, int D, float x,
                                       float y) {
  p += col;
  if (V || (col + 1 < D && !(reinterpret_cast<uintptr_t>(p) & (2 * sizeof(T) - 1)))) {
    if constexpr (std::is_same<T, float>::value)
      *reinterpret_cast<float2*>(p) = make_float2(x, y);
    else
      *reinterpret_cast<uint32_t*>(p) = pack2<T>(x, y);
  } else {
    if (col < D) p[0] = to_elem<T>(x);
    if (col + 1 < D) p[1] = to_elem<T>(y);
  }
}

// Rows row0 and row1 (those below ``rows``) of a C-fragment accumulator,
// times x0 and x1, into columns [0, D) of rows of ``base`` ``ld`` apart
template <typename T, bool V, int ND>
__device__ __forceinline__ void store_rows(T* base, long long ld, int row0,
                                           int row1, int rows, int D, int t4,
                                           const float (&a)[ND][4],
                                           float x0 = 1.f, float x1 = 1.f) {
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int col = j * 8 + t4 * 2;
    if (col >= D) continue;
    if (row0 < rows) store2<T, V>(base + (long long)row0 * ld, col, D, a[j][0] * x0, a[j][1] * x0);
    if (row1 < rows) store2<T, V>(base + (long long)row1 * ld, col, D, a[j][2] * x1, a[j][3] * x1);
  }
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

// The forward's step over one tile of scores s, C fragments of rows row0
// and row1 at columns k0 + 8 j + 2 t + e % 2: columns past Sk or, causal,
// right of the row masked, then the online softmax with exponent base 2
// (c = scale log2 e): s becomes P, and o and the lane's sums l are
// rescaled to the new row maxima m.
template <int NS, int ND>
__device__ __forceinline__ void softmax_tile(float (&s)[NS][4],
                                             float (&o)[ND][4], float& m0,
                                             float& m1, float& l0, float& l1,
                                             float c, int k0, int w0, int t4,
                                             int row0, int row1, int Sk,
                                             int causal) {
  constexpr int BN = NS * 8;
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
}

// dS = P (dP - delta) scale of one tile into s, P = exp2(s c - lb)
// recomputed from the scores (lb = lse log2 e), 0 where masked: columns
// past Sk or, causal, right of the row
template <int NS>
__device__ __forceinline__ void ds_tile(float (&s)[NS][4],
                                        const float (&dp)[NS][4], float c,
                                        float scale, float lb0, float lb1,
                                        float dl0, float dl1, int k0, int w0,
                                        int t4, int row0, int row1, int Sk,
                                        int causal) {
  constexpr int BN = NS * 8;
  const bool edge = k0 + BN > Sk || (causal && k0 + BN - 1 > w0);
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + j * 8 + t4 * 2 + (e & 1);
      const int row = e < 2 ? row0 : row1;
      const bool ok = !edge || (col < Sk && (!causal || col <= row));
      const float p = ok ? exp2f(fmaf(s[j][e], c, -(e < 2 ? lb0 : lb1))) : 0.f;
      s[j][e] = p * (dp[j][e] - (e < 2 ? dl0 : dl1)) * scale;
    }
}

// P^T into s and dS^T into dp of one transposed tile (the warp's keys key0
// and key1 of the block's BM from k0, queries q0 + 8 j + 2 t + e % 2, with
// their lse and delta in lse_s and dl_s), 0 where masked
template <int NS, int BM>
__device__ __forceinline__ void pds_tile(float (&s)[NS][4],
                                         float (&dp)[NS][4],
                                         const float* lse_s,
                                         const float* dl_s, float c,
                                         float scale, int q0, int k0, int w0,
                                         int t4, int key0, int key1, int Sq,
                                         int Sk, int causal) {
  constexpr int BN = NS * 8;
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
      dp[j][e] = p * (dp[j][e] - dl_s[qc]) * scale;
      s[j][e] = p;
    }
}

// ---------------------------------------------------------------- forward --
// Grid (B * N, ceil(Sq / BM)), BM / 16 warps.  Shared: Q [BM][DP], then two
// stages of K [BN][DP] and V [BN][DP].  Lane (g = lane / 4, t = lane % 4)
// of warp w holds rows q0 + 16 w + g and + 8 of the score tile.
template <typename T, int DP, int BM, int BN, bool V>
__global__ void __launch_bounds__(BM * 2, 1)
flash_fwd_tc(const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out,
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
  const T* kb = k + b * lk.b + n * lk.n;
  const T* vb = v + b * lv.b + n * lv.n;
  const int kv_end = causal ? min(Sk, q0 + BM) : Sk;
  const int tiles = (kv_end + BN - 1) / BN;

  load_tile<T, DP, BM, NT, V>(sq, q + b * lq.b + n * lq.n, lq.s, lq.vw, q0, Sq, D);
  cp_async_commit();
  load_tile<T, DP, BN, NT, V>(skv, kb, lk.s, lk.vw, 0, Sk, D);
  load_tile<T, DP, BN, NT, V>(skv + kTile, vb, lv.s, lv.vw, 0, Sk, D);
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
      load_tile<T, DP, BN, NT, V>(nxt, kb, lk.s, lk.vw, k0 + BN, Sk, D);
      load_tile<T, DP, BN, NT, V>(nxt + kTile, vb, lv.s, lv.vw, k0 + BN, Sk, D);
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
        mma<T>(s[j], qf[kk], bf[0], bf[1]);
        mma<T>(s[j + 1], qf[kk], bf[2], bf[3]);
      }

    softmax_tile(s, o, m0, m1, l0, l1, c, k0, w0, t4, row0, row1, Sk, causal);

#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t ph[4], pl[4];
      a_split<T>(s[2 * kk], s[2 * kk + 1], ph, pl);
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        uint32_t bf[4];
        ldsm_x4_t(bf, vs + frag_addr<DP>(kk * 16, j / 2, lane));
        mma<T>(o[j], ph, bf[0], bf[1]);
        mma<T>(o[j], pl, bf[0], bf[1]);
        mma<T>(o[j + 1], ph, bf[2], bf[3]);
        mma<T>(o[j + 1], pl, bf[2], bf[3]);
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }

  l0 = fmaxf(quad_sum(l0), 1e-30f);
  l1 = fmaxf(quad_sum(l1), 1e-30f);
  store_rows<T, V>(out + b * lo.b + n * lo.n, lo.s, row0, row1, Sq, D, t4, o,
                    1.f / l0, 1.f / l1);
  if (t4 == 0) {
    if (row0 < Sq) lse[(long long)bn * Sq + row0] = m0 * scale + logf(l0);
    if (row1 < Sq) lse[(long long)bn * Sq + row1] = m1 * scale + logf(l1);
  }
}

// ------------------------------------------------------------ backward dq --
// Grid (B * N, ceil(Sq / BM)).  Shared: Q, dO, O [BM][DP], then two stages
// of K [BN][DP] and V [BN][DP].  Writes delta for its rows first; the dk/dv
// kernel, next on the stream, reads it.
template <typename T, int DP, int BM, int BN, bool V>
__global__ void __launch_bounds__(BM * 2, 1)
flash_dq_tc(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const T* __restrict__ out, const float* __restrict__ lse,
          float* __restrict__ delta, T* __restrict__ dq, int N, int Sq,
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
  const T* kb = k + b * lk.b + n * lk.n;
  const T* vb = v + b * lv.b + n * lv.n;
  const T* dob = dout + b * ldo.b + n * ldo.n;
  const int kv_end = causal ? min(Sk, q0 + BM) : Sk;
  const int tiles = (kv_end + BN - 1) / BN;

  load_tile<T, DP, BM, NT, V>(sq, q + b * lq.b + n * lq.n, lq.s, lq.vw, q0, Sq, D);
  load_tile<T, DP, BM, NT, V>(sdo, dob, ldo.s, ldo.vw, q0, Sq, D);
  load_tile<T, DP, BM, NT, V>(so, out + b * lo.b + n * lo.n, lo.s, lo.vw, q0, Sq, D);
  cp_async_commit();
  load_tile<T, DP, BN, NT, V>(skv, kb, lk.s, lk.vw, 0, Sk, D);
  load_tile<T, DP, BN, NT, V>(skv + kTile, vb, lv.s, lv.vw, 0, Sk, D);
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
      mma<T>(d0, gf[kk], bf[0], bf[1]);
      mma<T>(d1, gf[kk], bf[2], bf[3]);
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
      load_tile<T, DP, BN, NT, V>(nxt, kb, lk.s, lk.vw, k0 + BN, Sk, D);
      load_tile<T, DP, BN, NT, V>(nxt + kTile, vb, lv.s, lv.vw, k0 + BN, Sk, D);
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
        mma<T>(s[j], qf[kk], bf[0], bf[1]);
        mma<T>(s[j + 1], qf[kk], bf[2], bf[3]);
        ldsm_x4(bf, vs + bn_addr<DP>(j * 8, kk, lane));
        mma<T>(dp[j], gf[kk], bf[0], bf[1]);
        mma<T>(dp[j + 1], gf[kk], bf[2], bf[3]);
      }

    ds_tile(s, dp, c, scale, lb0, lb1, dl0, dl1, k0, w0, t4, row0, row1, Sk, causal);

#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t hi[4], lo_[4];
      a_split<T>(s[2 * kk], s[2 * kk + 1], hi, lo_);
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        uint32_t bf[4];
        ldsm_x4_t(bf, ks + frag_addr<DP>(kk * 16, j / 2, lane));
        mma<T>(acc[j], hi, bf[0], bf[1]);
        mma<T>(acc[j], lo_, bf[0], bf[1]);
        mma<T>(acc[j + 1], hi, bf[2], bf[3]);
        mma<T>(acc[j + 1], lo_, bf[2], bf[3]);
      }
    }
    __syncthreads();
  }

  store_rows<T, V>(dq + b * ldq.b + n * ldq.n, ldq.s, row0, row1, Sq, D, t4, acc);
}

// --------------------------------------------------------- backward dk/dv --
// Grid (B * N, ceil(Sk / BM)).  The block owns keys k0 .. k0 + BM; lane
// (g, t) of warp w holds keys k0 + 16 w + g and + 8 of the transposed
// scores S^T = K Q^T.  Shared: K, V [BM][DP], then two stages of Q [BN][DP],
// dO [BN][DP], lse [BN] and delta [BN] f32.  K and V fragments stay in
// registers for DP <= 64 and are read from shared memory for DP = 128.
template <typename T, int DP, int BM, int BN, bool V>
__global__ void __launch_bounds__(BM * 2, 1)
flash_dkv_tc(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, int N, int Sq,
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
  const T* qb = q + b * lq.b + n * lq.n;
  const T* gb = dout + b * ldo.b + n * ldo.n;
  const float* lseb = lse + (long long)bn * Sq;
  const float* dlb = delta + (long long)bn * Sq;
  // query tiles before this key block's diagonal see none of its keys
  const int q_begin = causal ? (k0 / BN) * BN : 0;
  const int tiles = (Sq - q_begin + BN - 1) / BN;

  auto load_stage = [&](int st, int q0) {
    const uint32_t base = sring + st * kStage;
    load_tile<T, DP, BN, NT, V>(base, qb, lq.s, lq.vw, q0, Sq, D);
    load_tile<T, DP, BN, NT, V>(base + kTile, gb, ldo.s, ldo.vw, q0, Sq, D);
    for (int r = threadIdx.x; r < BN; r += NT) {
      const bool ok = q0 + r < Sq;
      cp_async4(base + 2 * kTile + r * 4, ok ? lseb + q0 + r : lseb, ok);
      cp_async4(base + 2 * kTile + (BN + r) * 4, ok ? dlb + q0 + r : dlb, ok);
    }
  };

  load_tile<T, DP, BM, NT, V>(sk, k + b * lk.b + n * lk.n, lk.s, lk.vw, k0, Sk, D);
  load_tile<T, DP, BM, NT, V>(sv, v + b * lv.b + n * lv.n, lv.s, lv.vw, k0, Sk, D);
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
        mma<T>(s[j], kf[x], bf[0], bf[1]);
        mma<T>(s[j + 1], kf[x], bf[2], bf[3]);
        ldsm_x4(bf, gs + bn_addr<DP>(j * 8, kk, lane));
        mma<T>(dp[j], vf[x], bf[0], bf[1]);
        mma<T>(dp[j + 1], vf[x], bf[2], bf[3]);
      }
    }

    pds_tile<NS, BM>(s, dp, lse_s, dl_s, c, scale, q0, k0, w0, t4, key0, key1, Sq, Sk, causal);

#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t ph[4], pl[4], dh[4], dlo[4];
      a_split<T>(s[2 * kk], s[2 * kk + 1], ph, pl);
      a_split<T>(dp[2 * kk], dp[2 * kk + 1], dh, dlo);
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        uint32_t bf[4];
        ldsm_x4_t(bf, gs + frag_addr<DP>(kk * 16, j / 2, lane));
        mma<T>(av[j], ph, bf[0], bf[1]);
        mma<T>(av[j], pl, bf[0], bf[1]);
        mma<T>(av[j + 1], ph, bf[2], bf[3]);
        mma<T>(av[j + 1], pl, bf[2], bf[3]);
        ldsm_x4_t(bf, qs + frag_addr<DP>(kk * 16, j / 2, lane));
        mma<T>(ak[j], dh, bf[0], bf[1]);
        mma<T>(ak[j], dlo, bf[0], bf[1]);
        mma<T>(ak[j + 1], dh, bf[2], bf[3]);
        mma<T>(ak[j + 1], dlo, bf[2], bf[3]);
      }
    }
    __syncthreads();
  }

  store_rows<T, V>(dk + b * ldk.b + n * ldk.n, ldk.s, key0, key1, Sk, D, t4, ak);
  store_rows<T, V>(dv + b * ldv.b + n * ldv.n, ldv.s, key0, key1, Sk, D, t4, av);
}


// ================================ f32: three TF32 products a product ==
// The design of the 16-bit kernels above over split f32 tiles (the note
// at the top): the same grids, warps, masks, row order and softmax.

// x rounded to TF32 (the low 13 mantissa bits zero), to nearest, ties
// away from zero
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x as hi + lo, both TF32: hi = tf32(x), lo = tf32(x - hi).  x - hi is
// exact, so hi + lo keeps 22 of x's 24 significant bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a (16 x 8, row) * b (8 x 8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment (16 x 8) as its TF32 parts.  Lane (g = lane / 4, t =
// lane % 4) holds, in order, (row g, column t), (g + 8, t), (g, t + 4) and
// (g + 8, t + 4).
struct Frag {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ Frag frag(float a0, float a1, float a2, float a3) {
  Frag f;
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
  return f;
}

// Tiles in shared memory have a row pitch of LD = DP + 4 floats: the
// fragment reads below (lane (g, t) at row g, columns t and t + 4; or rows
// 2t and 2t + 1, column g) then take 32 distinct banks, and every address
// is the lane's base plus a constant.  A raw tile holds f32 values; a
// split tile [2][rows][LD] holds the hi parts, then the lo parts PL words
// on.

// The A fragment of rows [r0, r0 + 16) x columns [c0, c0 + 8): of a raw
// tile, split here; of a split tile, as it is
template <int LD>
__device__ __forceinline__ Frag a_raw(const float* s, int r0, int c0, int g,
                                      int t) {
  const float* p = s + (r0 + g) * LD + c0 + t;
  return frag(p[0], p[8 * LD], p[4], p[8 * LD + 4]);
}

template <int LD, int PL>
__device__ __forceinline__ Frag a_planes(const uint32_t* s, int r0, int c0,
                                         int g, int t) {
  const uint32_t* p = s + (r0 + g) * LD + c0 + t;
  return Frag{{p[0], p[8 * LD], p[4], p[8 * LD + 4]},
              {p[PL], p[PL + 8 * LD], p[PL + 4], p[PL + 8 * LD + 4]}};
}

// A C fragment (16 x 8 of an f32 product; lane (g, t) holds columns 2t and
// 2t + 1 of rows g and g + 8), split, as the A fragment of the next
// product, whose k dimension its 8 columns become: logical column t is
// column 2t and t + 4 is 2t + 1, the order in which mma3_kn reads B's k
// rows.
__device__ __forceinline__ Frag a_of_c(const float (&c)[4]) {
  return frag(c[0], c[2], c[1], c[3]);
}

// c += a b to f32 accuracy, (h0, l0) and (h1, l1) the lane's two B
// elements: three TF32 products, the two small ones first (lo lo is below
// f32's own rounding)
__device__ __forceinline__ void mma3(float (&c)[4], const Frag& a,
                                     uint32_t h0, uint32_t l0, uint32_t h1,
                                     uint32_t l1) {
  mma_tf32(c, a.lo, h0, h1);
  mma_tf32(c, a.hi, l0, l1);
  mma_tf32(c, a.hi, h0, h1);
}

// c += a B, B the 8 x 8 block of a split [n][k] tile at rows [n0, n0 + 8)
// and columns [k0, k0 + 8): K for Q K^T, V for dO V^T, Q and dO for the
// transposed scores of the dk/dv kernel
template <int LD, int PL>
__device__ __forceinline__ void mma3_nk(float (&c)[4], const Frag& a,
                                        const uint32_t* s, int n0, int k0,
                                        int g, int t) {
  const uint32_t* p = s + (n0 + g) * LD + k0 + t;
  mma3(c, a, p[0], p[PL], p[4], p[PL + 4]);
}

// c += a B, B the 8 x 8 block of a split [k][n] tile at rows [k0, k0 + 8)
// (in a_of_c's order) and columns [n0, n0 + 8): V for P V, K for dS K, dO
// and Q for dV and dK
template <int LD, int PL>
__device__ __forceinline__ void mma3_kn(float (&c)[4], const Frag& a,
                                        const uint32_t* s, int k0, int n0,
                                        int g, int t) {
  const uint32_t* p = s + (k0 + 2 * t) * LD + n0 + g;
  mma3(c, a, p[0], p[PL], p[LD], p[PL + LD]);
}

// Async copy of rows [r0, r0 + ROWS) of one (b, n) slice into a raw
// [ROWS][DP + 4] tile at shared address ``dst``; rows at or past ``rows``
// and columns at or past D are zeros.  A 16-byte chunk (4 floats) is one
// cp.async at copy width 16, two or four at 8 or 4, the pieces past D
// zero-filled by a source size of 0 (their address is the slice's start,
// which is not read).
template <int DP, int ROWS, int NT, bool V>
__device__ __forceinline__ void load_tile_f32(uint32_t dst, const float* base,
                                              long long stride, int vw,
                                              int r0, int rows, int D) {
  constexpr int R = DP / 4, LD = DP + 4;
  for (int e = threadIdx.x; e < ROWS * R; e += NT) {
    const int r = e / R, c = e % R;
    const uint32_t d = dst + (uint32_t)(r * LD + c * 4) * 4;
    const int n = r0 + r < rows ? min(4, D - c * 4) : 0;  // live elements
    const float* src = base + (long long)(r0 + r) * stride + c * 4;
    if (V || vw == 16) {  // D % 4 == 0: a chunk is all live or all dead
      cp_async16(d, n > 0 ? src : base, n > 0);
    } else if (vw == 8) {
      cp_async8(d, n > 0 ? src : base, n > 0);
      cp_async8(d + 8, n > 2 ? src + 2 : base, n > 2);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        cp_async4(d + 4 * i, i < n ? src + i : base, i < n);
    }
  }
}

// A raw [ROWS][DP + 4] tile split into the split tile at ``dst`` by the
// whole block, four elements a thread at a time (the pad columns, which no
// fragment reads, are left)
template <int DP, int ROWS, int NT>
__device__ __forceinline__ void split_tile(const float* raw, uint32_t* dst) {
  constexpr int LD = DP + 4, R = DP / 4;
  for (int e = threadIdx.x; e < ROWS * R; e += NT) {
    const int i = (e / R) * LD + (e % R) * 4;
    const float4 x = *reinterpret_cast<const float4*>(raw + i);
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(dst + i) = h;
    *reinterpret_cast<uint4*>(dst + ROWS * LD + i) = l;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// ------------------------------------------------------------ f32 forward --
// flash_fwd_tc over split tiles.  Shared: Q split [2][BM][LD], K and V
// split [2][BN][LD] each, then raw K and V [BN][LD], which the next tile's
// copies fill while this one computes (Q's raw rows pass through the K/V
// split space first).
template <int DP, int BM, int BN, bool V>
__global__ void __launch_bounds__(BM * 2, 1)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int N, int Sq, int Sk, int D, Layout lq,
    Layout lk, Layout lv, Layout lo, int causal, float scale) {
  constexpr int NT = BM * 2, LD = DP + 4, KS = DP / 8, NS = BN / 8;
  constexpr int PQ = BM * LD, PT = BN * LD;  // planes: Q's, a K/V tile's
  static_assert(BM <= 4 * BN, "Q's raw rows fit the K/V split space");
  extern __shared__ __align__(128) uint32_t smw[];
  uint32_t* sq = smw;
  uint32_t* sk = sq + 2 * PQ;
  uint32_t* sv = sk + 2 * PT;
  float* raw = reinterpret_cast<float*>(sv + 2 * PT);
  const uint32_t raw_a = smem_u32(raw);

  const int bn = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest rows first
  const int b = bn / N, n = bn % N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int w0 = q0 + warp * 16, row0 = w0 + g, row1 = row0 + 8;
  const float* kb = k + b * lk.b + n * lk.n;
  const float* vb = v + b * lv.b + n * lv.n;
  const int kv_end = causal ? min(Sk, q0 + BM) : Sk;
  const int tiles = (kv_end + BN - 1) / BN;

  load_tile_f32<DP, BM, NT, V>(smem_u32(sk), q + b * lq.b + n * lq.n, lq.s, lq.vw, q0, Sq, D);
  load_tile_f32<DP, BN, NT, V>(raw_a, kb, lk.s, lk.vw, 0, Sk, D);
  load_tile_f32<DP, BN, NT, V>(raw_a + PT * 4, vb, lv.s, lv.vw, 0, Sk, D);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split_tile<DP, BM, NT>(reinterpret_cast<const float*>(sk), sq);
  __syncthreads();
  split_tile<DP, BN, NT>(raw, sk);
  split_tile<DP, BN, NT>(raw + PT, sv);
  __syncthreads();

  const float c = scale * kLog2e;
  float o[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * BN;
    const bool more = it + 1 < tiles;
    if (more) {  // the next tile's raw rows arrive while this one computes
      load_tile_f32<DP, BN, NT, V>(raw_a, kb, lk.s, lk.vw, k0 + BN, Sk, D);
      load_tile_f32<DP, BN, NT, V>(raw_a + PT * 4, vb, lv.s, lv.vw, k0 + BN, Sk, D);
      cp_async_commit();
    }

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const Frag a = a_planes<LD, PQ>(sq, warp * 16, kk * 8, g, t4);
#pragma unroll
      for (int j = 0; j < NS; ++j) mma3_nk<LD, PT>(s[j], a, sk, j * 8, kk * 8, g, t4);
    }

    softmax_tile(s, o, m0, m1, l0, l1, c, k0, w0, t4, row0, row1, Sk, causal);

#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {  // 8 keys a step
      const Frag p = a_of_c(s[kk]);
#pragma unroll
      for (int j = 0; j < KS; ++j) mma3_kn<LD, PT>(o[j], p, sv, kk * 8, j * 8, g, t4);
    }
    if (more) {
      cp_async_wait<0>();
      __syncthreads();  // every warp is done with this tile; the next is in
      split_tile<DP, BN, NT>(raw, sk);
      split_tile<DP, BN, NT>(raw + PT, sv);
      __syncthreads();
    }
  }

  l0 = fmaxf(quad_sum(l0), 1e-30f);
  l1 = fmaxf(quad_sum(l1), 1e-30f);
  store_rows<float, V>(out + b * lo.b + n * lo.n, lo.s, row0, row1, Sq, D, t4, o,
                    1.f / l0, 1.f / l1);
  if (t4 == 0) {
    if (row0 < Sq) lse[(long long)bn * Sq + row0] = m0 * scale + logf(l0);
    if (row1 < Sq) lse[(long long)bn * Sq + row1] = m1 * scale + logf(l1);
  }
}

// -------------------------------------------------------- f32 backward dq --
// flash_dq_tc over split tiles.  Shared: Q split [2][BM][LD], dO raw
// [BM][LD] (its fragments split at each use, which keeps two blocks an
// SM), K and V split [2][BN][LD] each, raw K and V [BN][LD].  Writes delta
// for its rows first; the dk/dv kernel, next on the stream, reads it.
template <int DP, int BM, int BN, bool V>
__global__ void __launch_bounds__(BM * 2, 1)
flash_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ out, const float* __restrict__ lse,
    float* __restrict__ delta, float* __restrict__ dq, int N, int Sq,
    int Sk, int D, Layout lq, Layout lk, Layout lv, Layout ldo,
    Layout lo, Layout ldq, int causal, float scale) {
  constexpr int NT = BM * 2, LD = DP + 4, KS = DP / 8, NS = BN / 8;
  constexpr int PQ = BM * LD, PT = BN * LD;
  static_assert(BM <= 4 * BN, "Q's raw rows fit the K/V split space");
  extern __shared__ __align__(128) uint32_t smw[];
  uint32_t* sq = smw;
  float* sdo = reinterpret_cast<float*>(sq + 2 * PQ);
  uint32_t* sk = reinterpret_cast<uint32_t*>(sdo + PQ);
  uint32_t* sv = sk + 2 * PT;
  float* raw = reinterpret_cast<float*>(sv + 2 * PT);
  const uint32_t raw_a = smem_u32(raw);

  const int bn = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int b = bn / N, n = bn % N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int w0 = q0 + warp * 16, row0 = w0 + g, row1 = row0 + 8;
  const float* kb = k + b * lk.b + n * lk.n;
  const float* vb = v + b * lv.b + n * lv.n;
  const int kv_end = causal ? min(Sk, q0 + BM) : Sk;
  const int tiles = (kv_end + BN - 1) / BN;

  load_tile_f32<DP, BM, NT, V>(smem_u32(sk), q + b * lq.b + n * lq.n, lq.s, lq.vw, q0, Sq, D);
  load_tile_f32<DP, BM, NT, V>(smem_u32(sdo), dout + b * ldo.b + n * ldo.n, ldo.s, ldo.vw, q0, Sq, D);
  load_tile_f32<DP, BN, NT, V>(raw_a, kb, lk.s, lk.vw, 0, Sk, D);
  load_tile_f32<DP, BN, NT, V>(raw_a + PT * 4, vb, lv.s, lv.vw, 0, Sk, D);
  cp_async_commit();
  const float lb0 = row0 < Sq ? lse[(long long)bn * Sq + row0] * kLog2e : 0.f;
  const float lb1 = row1 < Sq ? lse[(long long)bn * Sq + row1] * kLog2e : 0.f;
  cp_async_wait<0>();
  __syncthreads();
  split_tile<DP, BM, NT>(reinterpret_cast<const float*>(sk), sq);

  // delta of the warp's 16 rows in f32, a row at a time across the warp:
  // dO from its tile, O read once from device memory
  float dl0 = 0.f, dl1 = 0.f;
  {
    const float* ob = out + b * lo.b + n * lo.n;
    for (int r = 0; r < 16; ++r) {
      const int row = w0 + r;
      float x = 0.f;
      if (row < Sq)
        for (int d = lane; d < D; d += 32)
          x += sdo[(warp * 16 + r) * LD + d] * ob[(long long)row * lo.s + d];
      x = warp_sum(x);
      if (r == g) dl0 = x;
      if (r == g + 8) dl1 = x;
      if (lane == 0 && row < Sq) delta[(long long)bn * Sq + row] = x;
    }
  }
  __syncthreads();
  split_tile<DP, BN, NT>(raw, sk);
  split_tile<DP, BN, NT>(raw + PT, sv);
  __syncthreads();

  const float c = scale * kLog2e;
  float acc[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * BN;
    const bool more = it + 1 < tiles;
    if (more) {
      load_tile_f32<DP, BN, NT, V>(raw_a, kb, lk.s, lk.vw, k0 + BN, Sk, D);
      load_tile_f32<DP, BN, NT, V>(raw_a + PT * 4, vb, lv.s, lv.vw, k0 + BN, Sk, D);
      cp_async_commit();
    }

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const Frag a = a_planes<LD, PQ>(sq, warp * 16, kk * 8, g, t4);
      const Frag gf = a_raw<LD>(sdo, warp * 16, kk * 8, g, t4);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        mma3_nk<LD, PT>(s[j], a, sk, j * 8, kk * 8, g, t4);
        mma3_nk<LD, PT>(dp[j], gf, sv, j * 8, kk * 8, g, t4);
      }
    }

    ds_tile(s, dp, c, scale, lb0, lb1, dl0, dl1, k0, w0, t4, row0, row1, Sk, causal);

#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      const Frag ds = a_of_c(s[kk]);
#pragma unroll
      for (int j = 0; j < KS; ++j) mma3_kn<LD, PT>(acc[j], ds, sk, kk * 8, j * 8, g, t4);
    }
    if (more) {
      cp_async_wait<0>();
      __syncthreads();
      split_tile<DP, BN, NT>(raw, sk);
      split_tile<DP, BN, NT>(raw + PT, sv);
      __syncthreads();
    }
  }

  store_rows<float, V>(dq + b * ldq.b + n * ldq.n, ldq.s, row0, row1, Sq, D, t4, acc);
}

// ----------------------------------------------------- f32 backward dk/dv --
// flash_dkv_tc over split tiles.  Shared: K split [2][BM][LD], V raw
// [BM][LD] (split at each use, as dq's dO), Q and dO split [2][BN][LD]
// each, raw Q and dO [BN][LD], then lse and delta [BN] in two stages.
template <int DP, int BM, int BN, bool V>
__global__ void __launch_bounds__(BM * 2, 1)
flash_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int N, int Sq,
    int Sk, int D, Layout lq, Layout lk, Layout lv, Layout ldo,
    Layout ldk, Layout ldv, int causal, float scale) {
  constexpr int NT = BM * 2, LD = DP + 4, KS = DP / 8, NS = BN / 8;
  constexpr int PK = BM * LD, PT = BN * LD;
  static_assert(BM <= 4 * BN, "K's raw rows fit the Q/dO split space");
  extern __shared__ __align__(128) uint32_t smw[];
  uint32_t* sk = smw;
  float* sv = reinterpret_cast<float*>(sk + 2 * PK);
  uint32_t* sq = reinterpret_cast<uint32_t*>(sv + PK);
  uint32_t* sg = sq + 2 * PT;
  float* raw = reinterpret_cast<float*>(sg + 2 * PT);
  float* lsd = raw + 2 * PT;  // [2][lse, delta][BN]
  const uint32_t raw_a = smem_u32(raw), lsd_a = smem_u32(lsd);

  const int bn = blockIdx.x;
  const int k0 = blockIdx.y * BM;  // key tile 0 has the longest causal loop
  const int b = bn / N, n = bn % N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int w0 = k0 + warp * 16, key0 = w0 + g, key1 = key0 + 8;
  const float* qb = q + b * lq.b + n * lq.n;
  const float* gb = dout + b * ldo.b + n * ldo.n;
  const float* lseb = lse + (long long)bn * Sq;
  const float* dlb = delta + (long long)bn * Sq;
  // query tiles before this key block's diagonal see none of its keys
  const int q_begin = causal ? (k0 / BN) * BN : 0;
  const int tiles = (Sq - q_begin + BN - 1) / BN;

  auto load_stage = [&](int st, int q0) {
    load_tile_f32<DP, BN, NT, V>(raw_a, qb, lq.s, lq.vw, q0, Sq, D);
    load_tile_f32<DP, BN, NT, V>(raw_a + PT * 4, gb, ldo.s, ldo.vw, q0, Sq, D);
    const uint32_t ls = lsd_a + st * 2 * BN * 4;
    for (int r = threadIdx.x; r < BN; r += NT) {
      const bool ok = q0 + r < Sq;
      cp_async4(ls + r * 4, ok ? lseb + q0 + r : lseb, ok);
      cp_async4(ls + (BN + r) * 4, ok ? dlb + q0 + r : dlb, ok);
    }
  };

  load_tile_f32<DP, BM, NT, V>(smem_u32(sq), k + b * lk.b + n * lk.n, lk.s, lk.vw, k0, Sk, D);
  load_tile_f32<DP, BM, NT, V>(smem_u32(sv), v + b * lv.b + n * lv.n, lv.s, lv.vw, k0, Sk, D);
  load_stage(0, q_begin);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split_tile<DP, BM, NT>(reinterpret_cast<const float*>(sq), sk);
  __syncthreads();
  split_tile<DP, BN, NT>(raw, sq);
  split_tile<DP, BN, NT>(raw + PT, sg);
  __syncthreads();

  const float c = scale * kLog2e;
  float ak[KS][4], av[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[j][e] = av[j][e] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int q0 = q_begin + it * BN;
    const bool more = it + 1 < tiles;
    if (more) {
      load_stage((it + 1) & 1, q0 + BN);
      cp_async_commit();
    }
    const float* lse_s = lsd + (it & 1) * 2 * BN;
    const float* dl_s = lse_s + BN;

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const Frag a = a_planes<LD, PK>(sk, warp * 16, kk * 8, g, t4);
      const Frag w = a_raw<LD>(sv, warp * 16, kk * 8, g, t4);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        mma3_nk<LD, PT>(s[j], a, sq, j * 8, kk * 8, g, t4);
        mma3_nk<LD, PT>(dp[j], w, sg, j * 8, kk * 8, g, t4);
      }
    }

    pds_tile<NS, BM>(s, dp, lse_s, dl_s, c, scale, q0, k0, w0, t4, key0, key1, Sq, Sk, causal);

#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      const Frag p = a_of_c(s[kk]);
      const Frag d = a_of_c(dp[kk]);
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        mma3_kn<LD, PT>(av[j], p, sg, kk * 8, j * 8, g, t4);
        mma3_kn<LD, PT>(ak[j], d, sq, kk * 8, j * 8, g, t4);
      }
    }
    if (more) {
      cp_async_wait<0>();
      __syncthreads();
      split_tile<DP, BN, NT>(raw, sq);
      split_tile<DP, BN, NT>(raw + PT, sg);
      __syncthreads();
    }
  }

  store_rows<float, V>(dk + b * ldk.b + n * ldk.n, ldk.s, key0, key1, Sk, D, t4, ak);
  store_rows<float, V>(dv + b * ldv.b + n * ldv.n, ldv.s, key0, key1, Sk, D, t4, av);
}

// The kernels and dynamic shared bytes of one instance: the 16-bit
// kernels for bf16 and f16, the f32 ones for float.
template <typename T, int DP, int BM, int BN, bool V>
struct Inst {
  static auto fwd() { return flash_fwd_tc<T, DP, BM, BN, V>; }
  static auto dq() { return flash_dq_tc<T, DP, BM, BN, V>; }
  static auto dkv() { return flash_dkv_tc<T, DP, BM, BN, V>; }
  static constexpr size_t fwd_smem = 2 * DP * (BM + 4 * BN);
  static constexpr size_t dq_smem = 2 * DP * (3 * BM + 4 * BN);
  static constexpr size_t dkv_smem = 2 * DP * (2 * BM + 4 * BN) + 16 * BN;
};

template <int DP, int BM, int BN, bool V>
struct Inst<float, DP, BM, BN, V> {
  static auto fwd() { return flash_fwd_f32<DP, BM, BN, V>; }
  static auto dq() { return flash_dq_f32<DP, BM, BN, V>; }
  static auto dkv() { return flash_dkv_f32<DP, BM, BN, V>; }
  static constexpr size_t fwd_smem = 4 * (DP + 4) * (2 * BM + 6 * BN);
  static constexpr size_t dq_smem = 4 * (DP + 4) * (3 * BM + 6 * BN);
  static constexpr size_t dkv_smem = 4 * (DP + 4) * (3 * BM + 6 * BN) + 16 * BN;
};

// The streamed tile's rows (BN) of an instance; BM is 64 throughout.  The
// 16-bit types take 64 up to DP 64 and 32 at 128; f32 takes 32 at every
// DP, its streamed tiles being held three times (raw, hi, lo) at twice
// the bytes.
template <typename T, int DP>
constexpr int kBN = (std::is_same<T, float>::value || DP == 128) ? 32 : 64;

// grid rows: (b, n) in x, row tiles in y (at most 65535 of them)
int check_grid(int S, int BM) {
  return (S + BM - 1) / BM <= 65535 ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T, int DP, int BM, int BN, bool V>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int N, int Sq, int Sk, int D,
               const long long* st, int causal, float scale, cudaStream_t s) {
  using K = Inst<T, DP, BM, BN, V>;
  static bool raised = false;  // per instantiation
  const auto kernel = K::fwd();
  constexpr int es = sizeof(T);
  if (int e = check_grid(Sq, BM)) return e;
  cudaError_t err = allow_smem(kernel, K::fwd_smem, &raised);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(B * N, (Sq + BM - 1) / BM), BM * 2, K::fwd_smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, N, Sq, Sk,
      D, layout(st, 0, q, D, es), layout(st, 1, k, D, es),
      layout(st, 2, v, D, es), layout(st, 3, out, D, es), causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DP, int BM, int BN, bool V>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const void* out, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int N, int Sq, int Sk, int D,
               const long long* st, int causal, float scale, cudaStream_t s) {
  using K = Inst<T, DP, BM, BN, V>;
  static bool raised_dq = false, raised_dkv = false;  // per instantiation
  const auto kdq = K::dq();
  const auto kdkv = K::dkv();
  const void* ptrs[8] = {q, k, v, dout, dq, dk, dv, out};
  auto lay = [&](int t) { return layout(st, t, ptrs[t], D, sizeof(T)); };
  if (int e = check_grid(Sq, BM)) return e;
  if (int e = check_grid(Sk, BM)) return e;
  cudaError_t err = allow_smem(kdq, K::dq_smem, &raised_dq);
  if (err != cudaSuccess) return (int)err;
  kdq<<<dim3(B * N, (Sq + BM - 1) / BM), BM * 2, K::dq_smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const T*>(out), lse, delta, static_cast<T*>(dq), N,
      Sq, Sk, D, lay(0), lay(1), lay(2), lay(3), lay(7), lay(4), causal,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(kdkv, K::dkv_smem, &raised_dkv);
  if (err != cudaSuccess) return (int)err;
  kdkv<<<dim3(B * N, (Sk + BM - 1) / BM), BM * 2, K::dkv_smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse,
      delta, static_cast<T*>(dk), static_cast<T*>(dv), N, Sq, Sk, D,
      lay(0), lay(1), lay(2), lay(3), lay(5), lay(6), causal, scale);
  return (int)cudaGetLastError();
}

// The launches at these sizes, as kinfo records.
template <typename T, int DP, int BM, int BN, bool V>
int info_fwd(int B, int N, int Sq, int* out) {
  using K = Inst<T, DP, BM, BN, V>;
  static bool raised = false;
  cudaError_t err = allow_smem(K::fwd(), K::fwd_smem, &raised);
  if (err != cudaSuccess) return (int)err;
  return kinfo::record(K::fwd(), dim3(B * N, (Sq + BM - 1) / BM), BM * 2,
                       K::fwd_smem, out);
}

template <typename T, int DP, int BM, int BN, bool V>
int info_bwd(int B, int N, int Sq, int Sk, int* out) {
  using K = Inst<T, DP, BM, BN, V>;
  static bool raised_dq = false, raised_dkv = false;
  cudaError_t err = allow_smem(K::dq(), K::dq_smem, &raised_dq);
  if (err != cudaSuccess) return (int)err;
  int e = kinfo::record(K::dq(), dim3(B * N, (Sq + BM - 1) / BM), BM * 2,
                        K::dq_smem, out);
  if (e) return e;
  err = allow_smem(K::dkv(), K::dkv_smem, &raised_dkv);
  if (err != cudaSuccess) return (int)err;
  return kinfo::record(K::dkv(), dim3(B * N, (Sk + BM - 1) / BM), BM * 2,
                       K::dkv_smem, out);
}

}  // namespace tc

template <typename T, bool V>
int tc_info(int backward, int B, int N, int Sq, int Sk, int D, int* out) {
  if (!backward) {
    if (D <= 32) return tc::info_fwd<T, 32, 64, tc::kBN<T, 32>, V>(B, N, Sq, out);
    if (D <= 64) return tc::info_fwd<T, 64, 64, tc::kBN<T, 64>, V>(B, N, Sq, out);
    return tc::info_fwd<T, 128, 64, tc::kBN<T, 128>, V>(B, N, Sq, out);
  }
  if (D <= 32) return tc::info_bwd<T, 32, 64, tc::kBN<T, 32>, V>(B, N, Sq, Sk, out);
  if (D <= 64) return tc::info_bwd<T, 64, 64, tc::kBN<T, 64>, V>(B, N, Sq, Sk, out);
  return tc::info_bwd<T, 128, 64, tc::kBN<T, 128>, V>(B, N, Sq, Sk, out);
}

template <bool V>
int info(int backward, int dtype, int B, int N, int Sq, int Sk, int D,
         int* out) {
  if (dtype == 0) return tc_info<float, V>(backward, B, N, Sq, Sk, D, out);
  if (dtype == 1) return tc_info<tc::bf16, V>(backward, B, N, Sq, Sk, D, out);
  if (dtype == 2) return tc_info<tc::f16, V>(backward, B, N, Sq, Sk, D, out);
  return (int)cudaErrorInvalidValue;
}

// Whether every tensor of a launch takes the aligned instance: D % 8 == 0
// and each tensor's copy width 16 bytes.
bool aligned(const long long* strides, const void* const* ptrs, int n,
             int D, int esize) {
  if (D % 8) return false;
  for (int t = 0; t < n; ++t)
    if (layout(strides, t, ptrs[t], D, esize).vw != 16) return false;
  return true;
}

template <typename T, bool V>
int tc_fwd(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int N, int Sq, int Sk, int D, const long long* st,
           int causal, float scale, cudaStream_t s) {
  if (D <= 32) return tc::launch_fwd<T, 32, 64, tc::kBN<T, 32>, V>(q, k, v, out, lse, B, N, Sq, Sk, D, st, causal, scale, s);
  if (D <= 64) return tc::launch_fwd<T, 64, 64, tc::kBN<T, 64>, V>(q, k, v, out, lse, B, N, Sq, Sk, D, st, causal, scale, s);
  return tc::launch_fwd<T, 128, 64, tc::kBN<T, 128>, V>(q, k, v, out, lse, B, N, Sq, Sk, D, st, causal, scale, s);
}

template <bool V>
int fwd(const void* q, const void* k, const void* v, void* out, float* lse,
        int dtype, int B, int N, int Sq, int Sk, int D,
        const long long* st, int causal, float scale, cudaStream_t s) {
  if (dtype == 0) return tc_fwd<float, V>(q, k, v, out, lse, B, N, Sq, Sk, D, st, causal, scale, s);
  if (dtype == 1) return tc_fwd<tc::bf16, V>(q, k, v, out, lse, B, N, Sq, Sk, D, st, causal, scale, s);
  if (dtype == 2) return tc_fwd<tc::f16, V>(q, k, v, out, lse, B, N, Sq, Sk, D, st, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool V>
int tc_bwd(const void* q, const void* k, const void* v, const void* dout,
           const void* out, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int N, int Sq, int Sk, int D,
           const long long* st, int causal, float scale, cudaStream_t s) {
  if (D <= 32) return tc::launch_bwd<T, 32, 64, tc::kBN<T, 32>, V>(q, k, v, dout, out, lse, delta, dq, dk, dv, B, N, Sq, Sk, D, st, causal, scale, s);
  if (D <= 64) return tc::launch_bwd<T, 64, 64, tc::kBN<T, 64>, V>(q, k, v, dout, out, lse, delta, dq, dk, dv, B, N, Sq, Sk, D, st, causal, scale, s);
  return tc::launch_bwd<T, 128, 64, tc::kBN<T, 128>, V>(q, k, v, dout, out, lse, delta, dq, dk, dv, B, N, Sq, Sk, D, st, causal, scale, s);
}

template <bool V>
int bwd(const void* q, const void* k, const void* v, const void* dout,
        const void* out, const float* lse, float* delta, void* dq, void* dk,
        void* dv, int dtype, int B, int N, int Sq, int Sk, int D,
        const long long* st, int causal, float scale, cudaStream_t s) {
  if (dtype == 0) return tc_bwd<float, V>(q, k, v, dout, out, lse, delta, dq, dk, dv, B, N, Sq, Sk, D, st, causal, scale, s);
  if (dtype == 1) return tc_bwd<tc::bf16, V>(q, k, v, dout, out, lse, delta, dq, dk, dv, B, N, Sq, Sk, D, st, causal, scale, s);
  if (dtype == 2) return tc_bwd<tc::f16, V>(q, k, v, dout, out, lse, delta, dq, dk, dv, B, N, Sq, Sk, D, st, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The launch of flash_attention_fwd (backward 0) or flash_attention_bwd
// (backward 1) at these sizes: out[0] = its kernels (forward 1; backward
// 2: dq, which also writes delta, then dk/dv), then their
// kernel_info.cuh records.  Launches nothing.
extern "C" int flash_attention_info(int backward, int dtype, int B, int N,
                                    int Sq, int Sk, int D, int* out) {
  if (!shape_ok(D, Sq, Sk) || B < 1 || N < 1) return (int)cudaErrorInvalidValue;
  out[0] = 0;
  // the instance contiguous tensors take: the aligned one where D % 8 == 0
  if (D % 8 == 0) return info<true>(backward, dtype, B, N, Sq, Sk, D, out);
  return info<false>(backward, dtype, B, N, Sq, Sk, D, out);
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  ``strides`` holds (batch, seq, head)
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
  const void* ptrs[4] = {q, k, v, out};
  if (aligned(strides, ptrs, 4, D, dtype == 0 ? 4 : 2))
    return fwd<true>(q, k, v, out, lse, dtype, B, N, Sq, Sk, D, strides, causal, scale, s);
  return fwd<false>(q, k, v, out, lse, dtype, B, N, Sq, Sk, D, strides, causal, scale, s);
}

// Both backward passes on ``stream``: dq, which also writes delta =
// rowsum(dout * out) into ``delta`` ([B, N, Sq] f32 scratch), then dk/dv.  ``strides`` holds
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
  const void* ptrs[8] = {q, k, v, dout, dq, dk, dv, out};
  if (aligned(strides, ptrs, 8, D, dtype == 0 ? 4 : 2))
    return bwd<true>(q, k, v, dout, out, lse, delta, dq, dk, dv, dtype, B, N, Sq, Sk, D, strides, causal, scale, s);
  return bwd<false>(q, k, v, dout, out, lse, delta, dq, dk, dv, dtype, B, N, Sq, Sk, D, strides, causal, scale, s);
}
