// The split pass of bf16 K1 and of bf16-q K2 on Hopper's tensor cores
// (sm_90a): split_sm90<P, D, KW> over bf16 pages (P = __nv_bfloat16;
// paged_decode_attention.cu sends dtype 1 here) and over int8 pages
// with per-page fp32 scales (P = int8_t; paged_decode_attention_int8.cu
// sends bf16 q, dtype 1, here). fp32 K1 and fp32-q K2 keep the scalar
// split_kernel of paged_decode_attention.cuh: the tensor cores cannot
// hold fp32 to 1e-4. Replaces, for bf16 q, the TPU kernels
// ray_tpu/ops/paged_attention.py::_kernel (body _attend_page) and
// ::_kernel_q, both launched by paged_decode_attention there.
//
// Function: that of split_kernel<bf16, P, D>, merge included. One block
// per (slot, kv head, split of kWarps * KW keys) serves the rep <= 8
// query heads of its group (head h reads kv head h / rep); slot b sees
// keys 0..positions[b], clipped to the page-table window; fp32 scores
// from bf16 operands, scaled after the product, masked ones -1e30; the
// fp32 softmax's max floored at -1e29, so a warp with no visible key
// adds nothing; fp32 accumulation. The split's partial goes to
// merge_tail (paged_decode_attention.cuh), which merges the slot's
// splits in the block that finishes last: one launch per call.
// Rounding differs from the reference in one place: P is rounded to
// bf16 before the PV product (the reference keeps it in fp32); the row
// sum l is taken over the unrounded P. For int8 pages nothing else is
// rounded: q8 becomes bf16 exactly (|q8| <= 127), and the scales are
// folded in fp32 after the products consume q8, S = (Q q8^T) *
// (s_k / 127) / sqrt(D) per key, and P * (s_v / 127) per key before
// P's rounding. The result stays within the bf16 tolerance of the card
// tests (4e-3 + 2^-7 * |ref|).
//
// Bound: device memory. The pass must read each visible key and value
// once, 2 * sum_b(pos_b + 1) * KH * D * sizeof(P) bytes (int8: plus
// two fp32 scales per visible page and kv head): at the TinyLlama-1.1B
// decode shape (16 slots, 4 kv heads, D 64, ~16-18k visible keys)
// 16.8 MB for bf16, 5.0 us at 3.35 TB/s, and 9.5 MB for int8, 2.8 us.
// It does 4 * rep flops per element pair it reads, far below the ~295
// flop/byte where the tensor cores would become the limit. What bounds
// the scalar pass instead is its serial chain per 64-key tile:
// synchronous loads, then scores, softmax and a PV loop over the
// tile's keys, with five block barriers.
//
// Design:
//   - Prologue, nothing waiting that need not wait. The page ids of
//     this lane's rows are read together with positions[b] (issued by
//     asm volatile, so they stay ahead of the exit test; clamped to the
//     window, so none is out of bounds); then the block issues
//     cp.async (16 bytes a lane, neighbouring lanes on neighbouring
//     addresses) for its whole split at once: every K row as commit
//     group 0, every V row as group 1, each row through its own key's
//     page (any page size). Rows past the visible keys are zero-filled
//     (src-size 0), so no stale shared memory reaches a product. Only
//     then is Q loaded, straight into registers.
//   - Each of the 4 warps owns KW consecutive keys of the split and
//     copies exactly those rows itself, so a warp waits for its own
//     groups (cp.async.wait_group + __syncwarp): no block barrier until
//     the epilogue.
//   - int8 pages: a row's D bytes land in the upper half of its bf16
//     row; after its group lands, each lane widens the 16 bytes it
//     copied itself to 16 bf16 values in the lower half (one
//     __syncwarp between the warp's reads and writes of a row), so the
//     ldmatrix code below is bf16's unchanged. The widening runs on
//     byte permutes and fp32 adds (widen_int8), not on the conversion
//     unit, which converts 16 values a clock per SM. The lane that copies a
//     row's first chunk also loads its page's two scales (through the
//     page id it holds) and keeps (s_k / 127 / sqrt(D), s_v / 127) in
//     the row's 16 bytes of padding: any page size, no second walk over
//     the page table.
//   - Scores on the tensor cores: S = Q K^T with mma.sync.m16n8k16 (bf16
//     in, fp32 accumulators). Q's rep rows, zero-padded to 16, are the
//     register A operand (rows 8-15 are always zero, so those A registers
//     are constant zeros and that half of the accumulator is dropped); K
//     comes through ldmatrix from rows padded by 16 bytes, which puts
//     the 8 rows of each 8x8 matrix on distinct banks. 8 products per 16
//     keys at D 64.
//   - Softmax inside the warp: a row's scores live in the 4 lanes of a
//     quad, so its max and sum take two shuffles each; P goes from S's
//     accumulator fragments straight to bf16 A fragments (as FA2 does).
//   - PV on the tensor cores: after V's group, O += P V with V through
//     ldmatrix.trans from the same padded rows.
//   - Epilogue: one __syncthreads merges the 4 warps' (m, l, O[rep x D])
//     through shared memory (each warp's O over its own K rows). A slot
//     with one live split writes its output here; otherwise the
//     split's partial goes to merge_tail.
//   Shared memory: 2 * kWarps * KW rows of 2 * D + 16 bytes (dynamic,
//   after cudaFuncSetAttribute), the same for both page types, plus
//   ~0.3 KB static: at D 64, 72 KB for 256-key splits (3 blocks an
//   SM), 36 KB for 128-key ones (6).
//
// ptxas (-Xptxas -v, nvcc 12.9, sm_90a): bf16 pages split_sm90<bf16,
// 64, 64> (the served instance) 128 registers, <bf16, 64, 32> and
// <bf16, 64, 16> 128, <bf16, 128, 64> 189, <bf16, 128, 32> 128,
// <bf16, 128, 16> 128 with 16 bytes of spills; int8 pages <int8, 64,
// 64> (served) 146, <int8, 64, 32> and <int8, 64, 16> 128, <int8, 128,
// 64> 155, <int8, 128, 32> and <int8, 128, 16> 128 with 16 bytes of
// spills; no performance warnings. Registers allow 3 blocks an SM at
// 146 (shared memory allows 3 at 256-key splits) and 4 at 128.
// merge_tail's round of kMergeLoads partial values per thread set the
// 128: without it the same pass took 48-96 at D 64. chip_smoke.py
// phase 1 prints every instance's report on every build.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>


#include "paged_decode_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing L1; src_bytes 0
// reads nothing and writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's commit groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and lane l receives row l/4, columns 2(l%4) and 2(l%4)+1 of
// each (with .trans: of each matrix's transpose).
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// (c0, c1) += the top half of A B, m16n8k16, bf16 in, fp32 out, where
// A's rows 8-15 are zero: a0 holds A[g][2t..2t+1], a2 A[g][2t+8..2t+9]
// (g = lane / 4, t = lane % 4), (b0, b1) the B fragment. The bottom
// half of the accumulator (rows 8-15) is not kept.
__device__ __forceinline__ void mma_top(float& c0, float& c1, uint32_t a0,
                                        uint32_t a2, uint32_t b0,
                                        uint32_t b1) {
  float d2, d3;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %5}, {%7, %8}, {%0, %1, %9, %9};\n"
      : "+f"(c0), "+f"(c1), "=f"(d2), "=f"(d3)
      : "r"(a0), "r"(0u), "r"(a2), "r"(b0), "r"(b1), "f"(0.f));
}

// A read-only global load the compiler issues where it stands: the
// value is waited for only where it is used.
__device__ __forceinline__ int ld_issue(const int* p) {
  int v;
  asm volatile("ld.global.nc.b32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}


// 16 int8 values (one 16-byte word) as 16 bf16 values, exactly, on the
// integer and fp32 pipes rather than the conversion unit: byte x ^ 0x80
// = x + 128 goes into the mantissa of 2^23 (0x4B0000xx), 2^23 + 128 is
// subtracted in fp32, and the result, an integer of at most 8 bits, is
// the upper half of its fp32 bits in bf16.
__device__ __forceinline__ void widen_int8(const uint4& u, uint4& lo,
                                           uint4& hi) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t biased = w[i] ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 + j)) -
             8388736.0f;
    o[2 * i] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]),
                           0x7632);
    o[2 * i + 1] = __byte_perm(__float_as_uint(f[2]),
                               __float_as_uint(f[3]), 0x7632);
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

// Geometry of one (page type P, head_dim D, keys per warp KW) instance.
template <typename P, int D, int KW>
struct Sm90Split {
  static_assert(D % 32 == 0 && KW % 16 == 0, "D % 32, KW % 16");
  static constexpr bool kQuant = std::is_same<P, int8_t>::value;
  static constexpr int kKeys = kWarps * KW;           // keys per split
  static constexpr int kRowBytes = 2 * D + 16;        // padded bf16 row
  // where a copied row lands in its bf16 row: int8 in the upper half
  static constexpr int kStage = kQuant ? D : 0;
  static constexpr int kScale = 2 * D;                // int8: row scales
  static constexpr int kChunks = D * static_cast<int>(sizeof(P)) / 16;
  static constexpr int kElems = 16 / static_cast<int>(sizeof(P));
  static constexpr int kRowsPerPass = 32 / kChunks;   // rows a warp copies
  static constexpr int kPasses = KW / kRowsPerPass;   // ... per pass
  static constexpr int kOStride = D + 8;              // epilogue row
  static constexpr int kSmem = 2 * kKeys * kRowBytes;  // K and V rows
  // the epilogue's 8 rows of O per warp fit in the warp's own K rows,
  // and merge_tail's scratch in the K rows
  static_assert(8 * kOStride * 4 <= KW * kRowBytes, "O over K rows");
  static_assert(kKeys * kRowBytes >= kMergeScratch * 4, "scratch");
};

// int8 pages: the lane's rows of one group, each row's 16 bytes this
// lane copied widened to bf16 in the row's lower half.
template <typename G>
__device__ __forceinline__ void widen_rows(unsigned char* rows, int r0,
                                           int chunk) {
#pragma unroll
  for (int i = 0; i < G::kPasses; ++i) {
    unsigned char* row = rows + (r0 + i * G::kRowsPerPass) * G::kRowBytes;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(row + G::kStage + chunk * 16);
    __syncwarp();  // the warp has read the row before any lane writes it
    uint4 lo, hi;
    widen_int8(raw, lo, hi);
    *reinterpret_cast<uint4*>(row + chunk * 32) = lo;
    *reinterpret_cast<uint4*>(row + chunk * 32 + 16) = hi;
  }
}

template <typename P, int D, int KW>
__global__ void __launch_bounds__(kThreads) split_sm90(
    const bf16* __restrict__ q, const P* __restrict__ pages_k,
    const P* __restrict__ pages_v, const float* __restrict__ scales_k,
    const float* __restrict__ scales_v, const int* __restrict__ page_table,
    const int* __restrict__ positions, bf16* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_m,
    float* __restrict__ part_l, int* __restrict__ counters, int H, int KH,
    int n_pages, int Pg, int max_pages, float scale) {
  using G = Sm90Split<P, D, KW>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float m_s[kWarps * 8];   // each warp's row max and sum
  __shared__ float l_s[kWarps * 8];
  __shared__ float w_s[kWarps * 8];   // each warp's weight in its row
  __shared__ float rm_s[8];           // the split's row max and sum
  __shared__ float rl_s[8];
  unsigned char* k_s = smem;
  unsigned char* v_s = smem + G::kKeys * G::kRowBytes;

  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int s = blockIdx.z;
  const int rep = H / KH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // fragment row (query head of the group)
  const int t = lane & 3;    // fragment column pair
  const int window = max_pages * Pg;
  const int k0 = s * G::kKeys;
  const int w0 = warp * G::kKeys / kWarps;   // this warp's first row
  bf16* ob = out + (static_cast<size_t>(b) * H +
                    static_cast<size_t>(kh) * rep) * D;

  // 1. Page ids of this lane's rows, then positions[b], all in flight
  //    at once: the page-id loads are issued by asm volatile, so the
  //    compiler cannot sink them below the exit test and chain them
  //    behind positions[b] (the window clamp keeps every index in
  //    bounds, visible or not).
  const int* pt = page_table + static_cast<size_t>(b) * max_pages;
  const int chunk = lane % G::kChunks;
  const int r0 = w0 + lane / G::kChunks;
  int page[G::kPasses];
#pragma unroll
  for (int i = 0; i < G::kPasses; ++i)
    page[i] = ld_issue(pt + min(k0 + r0 + i * G::kRowsPerPass, window - 1) /
                                Pg);
  const Visible vis = visible(positions[b], window, G::kKeys);
  if (k0 >= vis.keys) {  // uniform over the block
    if (s == 0) write_zeros(ob, rep * D);
    return;
  }
  const int k1 = min(k0 + G::kKeys, vis.keys);

  // 2. The warp's K rows as commit group 0, its V rows as group 1.
  long long off[G::kPasses];
#pragma unroll
  for (int i = 0; i < G::kPasses; ++i) {
    const int key = k0 + r0 + i * G::kRowsPerPass;
    const int p = key / Pg;
    off[i] = key < k1 ? ((static_cast<long long>(kh) * n_pages + page[i]) *
                             Pg +
                         (key - p * Pg)) *
                                D +
                            chunk * G::kElems
                      : -1;
  }
  // int8: the scales of the pages of this lane's rows (first chunk's
  // lane only; 0 past the visible keys), asked for before the rows, so
  // that they do not queue behind them
  float sk_row[G::kQuant ? G::kPasses : 1], sv_row[G::kQuant ? G::kPasses : 1];
  if constexpr (G::kQuant) {
#pragma unroll
    for (int i = 0; i < G::kPasses; ++i) {
      const bool mine = chunk == 0 && off[i] >= 0;
      const size_t si = static_cast<size_t>(kh) * n_pages + page[i];
      sk_row[i] = mine ? __ldg(scales_k + si) : 0.f;
      sv_row[i] = mine ? __ldg(scales_v + si) : 0.f;
    }
  }
  const uint32_t dst = r0 * G::kRowBytes + G::kStage + chunk * 16;
#pragma unroll
  for (int i = 0; i < G::kPasses; ++i)
    cp_async16(smem_u32(k_s) + dst + i * G::kRowsPerPass * G::kRowBytes,
               off[i] >= 0 ? pages_k + off[i] : pages_k,
               off[i] >= 0 ? 16 : 0);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < G::kPasses; ++i)
    cp_async16(smem_u32(v_s) + dst + i * G::kRowsPerPass * G::kRowBytes,
               off[i] >= 0 ? pages_v + off[i] : pages_v,
               off[i] >= 0 ? 16 : 0);
  cp_async_commit();

  // 3. Q's row g (zero past rep) as A fragments: qa[kk] holds columns
  //    16kk + 2t.. and 16kk + 8 + 2t.. of the k-step kk.
  uint32_t qa[D / 16][2];
  const bf16* qrow =
      q + (static_cast<size_t>(b) * H + static_cast<size_t>(kh) * rep + g) *
              D;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = g < rep ? __ldg(reinterpret_cast<const unsigned int*>(
                              qrow + 16 * kk + 2 * t))
                        : 0u;
    qa[kk][1] = g < rep ? __ldg(reinterpret_cast<const unsigned int*>(
                              qrow + 16 * kk + 8 + 2 * t))
                        : 0u;
  }
  if constexpr (G::kQuant) {
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < G::kPasses; ++i)
        *reinterpret_cast<float2*>(
            k_s + (r0 + i * G::kRowsPerPass) * G::kRowBytes + G::kScale) =
            make_float2(sk_row[i] * (1.0f / 127.0f) * scale,
                        sv_row[i] * (1.0f / 127.0f));
    }
  }

  // 4. S = Q K^T over the warp's KW keys: n-tile j holds keys
  //    w0 + 8j.., lane (g, t) its row g at keys 2t and 2t + 1.
  cp_async_wait<1>();
  if constexpr (G::kQuant) widen_rows<G>(k_s, r0, chunk);
  __syncwarp();
  float sc[KW / 8][2];
  const uint32_t k_lane = smem_u32(k_s) + (w0 + (lane & 7)) * G::kRowBytes +
                          (lane >> 3) * 16;
#pragma unroll
  for (int j = 0; j < KW / 8; ++j) {
    sc[j][0] = 0.f;
    sc[j][1] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      uint32_t r[4];
      ldsm_x4(k_lane + 8 * j * G::kRowBytes + 64 * kk, r);
      mma_top(sc[j][0], sc[j][1], qa[2 * kk][0], qa[2 * kk][1], r[0], r[1]);
      mma_top(sc[j][0], sc[j][1], qa[2 * kk + 1][0], qa[2 * kk + 1][1],
              r[2], r[3]);
    }
  }

  // 5. Softmax of row g over the warp's keys, in the quad; P to bf16 A
  //    fragments (int8: times the key's s_v / 127 first).
  float vs[KW / 8][2];
  float mx = -1e30f;
#pragma unroll
  for (int j = 0; j < KW / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = w0 + 8 * j + 2 * t + e;
      float ks = scale;
      vs[j][e] = 1.f;
      if constexpr (G::kQuant) {
        const float2 rs = *reinterpret_cast<const float2*>(
            k_s + row * G::kRowBytes + G::kScale);
        ks = rs.x;
        vs[j][e] = rs.y;
      }
      sc[j][e] = k0 + row < k1 ? sc[j][e] * ks : -1e30f;
      mx = fmaxf(mx, sc[j][e]);
    }
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  mx = fmaxf(mx, -1e29f);
  float l = 0.f;
  uint32_t pa[KW / 8];
#pragma unroll
  for (int j = 0; j < KW / 8; ++j) {
    const float p0 = expf(sc[j][0] - mx);
    const float p1 = expf(sc[j][1] - mx);
    l += p0 + p1;
    pa[j] = G::kQuant ? pack_bf16(p0 * vs[j][0], p1 * vs[j][1])
                      : pack_bf16(p0, p1);
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);

  // 6. O = P V: k-step kc takes keys 16kc.. of the warp (S tiles 2kc and
  //    2kc + 1); V through ldmatrix.trans, two 8-column n-tiles a load.
  cp_async_wait<0>();
  if constexpr (G::kQuant) widen_rows<G>(v_s, r0, chunk);
  __syncwarp();
  float o[D / 8][2];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    o[n][0] = 0.f;
    o[n][1] = 0.f;
  }
  const uint32_t v_lane = smem_u32(v_s) +
                          (w0 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                              G::kRowBytes +
                          (lane >> 4) * 16;
#pragma unroll
  for (int kc = 0; kc < KW / 16; ++kc) {
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t r[4];
      ldsm_x4_trans(v_lane + 16 * kc * G::kRowBytes + 32 * np, r);
      mma_top(o[2 * np][0], o[2 * np][1], pa[2 * kc], pa[2 * kc + 1], r[0],
              r[1]);
      mma_top(o[2 * np + 1][0], o[2 * np + 1][1], pa[2 * kc],
              pa[2 * kc + 1], r[2], r[3]);
    }
  }

  // 7. Merge the 4 warps' (m, l, O); a warp's O goes over its own K
  //    rows, which no other warp reads.
  __syncwarp();
  float* orow =
      reinterpret_cast<float*>(k_s + w0 * G::kRowBytes) + g * G::kOStride;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) =
        make_float2(o[n][0], o[n][1]);
  if (t == 0) {
    m_s[warp * 8 + g] = mx;
    l_s[warp * 8 + g] = l;
  }
  __syncthreads();
  if (tid < rep) {
    const int r = tid;
    float m = m_s[r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, m_s[w * 8 + r]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(m_s[w * 8 + r] - m);
      w_s[w * 8 + r] = e;
      sum += l_s[w * 8 + r] * e;
    }
    rm_s[r] = m;
    rl_s[r] = sum;
  }
  __syncthreads();
  const bool alone = vis.splits == 1;   // normalise in place
  const size_t first = (static_cast<size_t>(b) * KH + kh) * gridDim.z;
  float* acc_out = part_acc + (first + s) * rep * D;
  for (int i = tid; i < rep * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      acc += reinterpret_cast<const float*>(
                 k_s + w * KW * G::kRowBytes)[r * G::kOStride + d] *
             w_s[w * 8 + r];
    if (alone)
      ob[i] = __float2bfloat16(acc / fmaxf(rl_s[r], 1e-30f));
    else
      acc_out[i] = acc;
  }
  if (alone) return;
  if (tid < rep) {
    part_m[(first + s) * rep + tid] = rm_s[tid];
    part_l[(first + s) * rep + tid] = rl_s[tid];
  }
  merge_tail<bf16, D>(part_acc, part_m, part_l,
                      counters + static_cast<size_t>(b) * KH + kh, first,
                      vis.splits, rep, ob, reinterpret_cast<float*>(k_s));
}

template <typename P, int D, int KW>
cudaError_t launch_sm90(const void* q, const void* pages_k,
                        const void* pages_v, const void* scales_k,
                        const void* scales_v, const void* page_table,
                        const void* positions, void* out, void* part_acc,
                        void* part_m, void* part_l, void* counters, int B,
                        int H, int KH, int n_pages, int Pg, int max_pages,
                        cudaStream_t stream) {
  using G = Sm90Split<P, D, KW>;
  cudaError_t err = cudaFuncSetAttribute(
      split_sm90<P, D, KW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::kSmem);
  if (err != cudaSuccess) return err;
  const int n_splits = (max_pages * Pg + G::kKeys - 1) / G::kKeys;
  split_sm90<P, D, KW>
      <<<dim3(B, KH, n_splits), kThreads, G::kSmem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const P*>(pages_k),
          static_cast<const P*>(pages_v),
          static_cast<const float*>(scales_k),
          static_cast<const float*>(scales_v),
          static_cast<const int*>(page_table),
          static_cast<const int*>(positions), static_cast<bf16*>(out),
          static_cast<float*>(part_acc), static_cast<float*>(part_m),
          static_cast<float*>(part_l), static_cast<int*>(counters), H, KH,
          n_pages, Pg, max_pages, 1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

// bf16 q over pages of type P at head_dim D and `split` keys per block
// (64, 128 or 256: 16, 32 or 64 keys per warp); anything else is
// cudaErrorInvalidValue. scales_k / scales_v are read for int8 pages
// only.
template <typename P, int D>
cudaError_t launch_split_sm90(const void* q, const void* pages_k,
                              const void* pages_v, const void* scales_k,
                              const void* scales_v, const void* page_table,
                              const void* positions, void* out,
                              void* part_acc, void* part_m, void* part_l,
                              void* counters, int B, int H, int KH,
                              int n_pages, int Pg, int max_pages, int split,
                              cudaStream_t stream) {
#define RTT_SM90(KW)                                                      \
  return launch_sm90<P, D, KW>(q, pages_k, pages_v, scales_k, scales_v,  \
                               page_table, positions, out, part_acc,     \
                               part_m, part_l, counters, B, H, KH,       \
                               n_pages, Pg, max_pages, stream)
  if (split == 64) RTT_SM90(16);
  if (split == 128) RTT_SM90(32);
  if (split == 256) RTT_SM90(64);
#undef RTT_SM90
  return cudaErrorInvalidValue;
}

}  // namespace
