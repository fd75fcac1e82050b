// K1's split pass for bf16 q and pages on Hopper's tensor cores
// (sm_90a): paged_decode_attention.cu dispatches dtype 1 (bf16) here;
// fp32 K1 and all of K2 keep the scalar split_kernel of
// paged_decode_attention.cuh. Replaces, for bf16, the TPU kernel
// ray_tpu/ops/paged_attention.py::_kernel (body _attend_page), launched
// by paged_decode_attention there.
//
// Function: that of split_kernel<bf16, bf16, D>. One block per (slot,
// kv head, split of kWarps * KW keys) serves the rep <= 8 query heads
// of its group (head h reads kv head h / rep); slot b sees keys
// 0..positions[b], clipped to the page-table window; fp32 scores from
// bf16 operands, scaled after the product, masked ones -1e30; the fp32
// softmax's max floored at -1e29, so a warp with no visible key adds
// nothing; fp32 accumulation. It writes the split's unnormalised output
// and its (max, sum) to part_acc / part_m / part_l, which merge_kernel
// (paged_decode_attention.cuh) merges as it does the scalar pass's.
// Rounding differs from the reference in one place: P is rounded to
// bf16 before the PV product (the reference keeps it in fp32); the row
// sum l is taken over the unrounded P. The result stays within the bf16
// tolerance of the card tests (4e-3 + 2^-7 * |ref|).
//
// Bound: device memory. The split pass must read each visible key and
// value once, 2 * sum_b(pos_b + 1) * KH * D * 2 bytes: 16.8 MB at the
// TinyLlama-1.1B decode shape (16 slots, 4 kv heads, D 64, 16,417
// visible keys), 5.0 us at 3.35 TB/s. It does 4 * rep flops per element
// pair it reads, far below the ~295 flop/byte where the tensor cores
// would become the limit. What bounds the scalar pass instead is its
// serial chain per 64-key tile: synchronous loads, then scores, softmax
// and a PV loop over the tile's keys, with five block barriers.
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
//     through shared memory (each warp's O over its own K rows) into
//     the split's partial, written as the scalar pass writes it.
//   Shared memory: 2 * kWarps * KW rows of 2 * D + 16 bytes (dynamic,
//   after cudaFuncSetAttribute): at D 64, 72 KB for the 256-key splits
//   the wrapper runs (3 blocks an SM), 36 KB for 128-key ones (6).
//
// ptxas (-Xptxas -v, nvcc 12.9, sm_90a): split_sm90<64, 64> (the
// served instance) 96 registers, <64, 32> 63, <64, 16> 48, <128, 64>
// 161, <128, 32> 112, <128, 16> 72; no spills, no performance warnings.
// chip_smoke.py phase 1 prints them on every build.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// Geometry of one (head_dim D, keys per warp KW) instance.
template <int D, int KW>
struct Sm90Split {
  static_assert(D % 32 == 0 && KW % 16 == 0, "D % 32, KW % 16");
  static constexpr int kKeys = kWarps * KW;           // keys per split
  static constexpr int kRowBytes = 2 * D + 16;        // padded K/V row
  static constexpr int kChunks = 2 * D / 16;          // 16 B per row
  static constexpr int kRowsPerPass = 32 / kChunks;   // rows a warp copies
  static constexpr int kPasses = KW / kRowsPerPass;   // ... per pass
  static constexpr int kOStride = D + 8;              // epilogue row
  static constexpr int kSmem = 2 * kKeys * kRowBytes;  // K and V rows
  // the epilogue's 8 rows of O per warp fit in the warp's own K rows
  static_assert(8 * kOStride * 4 <= KW * kRowBytes, "O over K rows");
};

template <int D, int KW>
__global__ void __launch_bounds__(kThreads) split_sm90(
    const bf16* __restrict__ q, const bf16* __restrict__ pages_k,
    const bf16* __restrict__ pages_v, const int* __restrict__ page_table,
    const int* __restrict__ positions, float* __restrict__ part_acc,
    float* __restrict__ part_m, float* __restrict__ part_l, int H, int KH,
    int n_pages, int Pg, int max_pages, float scale) {
  using G = Sm90Split<D, KW>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float m_s[kWarps * 8];   // each warp's row max and sum
  __shared__ float l_s[kWarps * 8];
  unsigned char* k_s = smem;
  unsigned char* v_s = smem + G::kKeys * G::kRowBytes;

  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int s = blockIdx.z;
  const int rep = H / KH;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;   // fragment row (query head of the group)
  const int t = lane & 3;    // fragment column pair
  const int window = max_pages * Pg;
  const int k0 = s * G::kKeys;
  const int w0 = warp * G::kKeys / kWarps;   // this warp's first row

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
  const int n_keys = min(positions[b] + 1, window);
  if (k0 >= n_keys) return;  // uniform over the block
  const int k1 = min(k0 + G::kKeys, n_keys);

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
                            chunk * 8
                      : -1;
  }
  const uint32_t dst = r0 * G::kRowBytes + chunk * 16;
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

  // 4. S = Q K^T over the warp's KW keys: n-tile j holds keys
  //    w0 + 8j.., lane (g, t) its row g at keys 2t and 2t + 1.
  cp_async_wait<1>();
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
  //    fragments.
  float mx = -1e30f;
#pragma unroll
  for (int j = 0; j < KW / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = k0 + w0 + 8 * j + 2 * t + e;
      sc[j][e] = key < k1 ? sc[j][e] * scale : -1e30f;
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
    pa[j] = pack_bf16(p0, p1);
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);

  // 6. O = P V: k-step kc takes keys 16kc.. of the warp (S tiles 2kc and
  //    2kc + 1); V through ldmatrix.trans, two 8-column n-tiles a load.
  cp_async_wait<0>();
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

  // 7. Merge the 4 warps' (m, l, O) into the split's partial; a warp's
  //    O goes over its own K rows, which no other warp reads.
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
  const size_t slot = (static_cast<size_t>(b) * KH + kh) * gridDim.z + s;
  for (int i = threadIdx.x; i < rep * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    float m = m_s[r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, m_s[w * 8 + r]);
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      acc += reinterpret_cast<const float*>(
                 k_s + w * KW * G::kRowBytes)[r * G::kOStride + d] *
             expf(m_s[w * 8 + r] - m);
    part_acc[(slot * rep + r) * D + d] = acc;
    if (d == 0) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        sum += l_s[w * 8 + r] * expf(m_s[w * 8 + r] - m);
      part_m[slot * rep + r] = m;
      part_l[slot * rep + r] = sum;
    }
  }
}

template <int D, int KW>
cudaError_t launch_sm90(const void* q, const void* pages_k,
                        const void* pages_v, const void* page_table,
                        const void* positions, void* out, void* part_acc,
                        void* part_m, void* part_l, int B, int H, int KH,
                        int n_pages, int Pg, int max_pages,
                        cudaStream_t stream) {
  using G = Sm90Split<D, KW>;
  cudaError_t err = cudaFuncSetAttribute(
      split_sm90<D, KW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::kSmem);
  if (err != cudaSuccess) return err;
  const int n_splits = (max_pages * Pg + G::kKeys - 1) / G::kKeys;
  split_sm90<D, KW><<<dim3(B, KH, n_splits), kThreads, G::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(pages_k),
      static_cast<const bf16*>(pages_v), static_cast<const int*>(page_table),
      static_cast<const int*>(positions), static_cast<float*>(part_acc),
      static_cast<float*>(part_m), static_cast<float*>(part_l), H, KH,
      n_pages, Pg, max_pages, 1.0f / sqrtf(static_cast<float>(D)));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<bf16><<<dim3(B, KH), kThreads, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_m),
      static_cast<const float*>(part_l), static_cast<const int*>(positions),
      static_cast<bf16*>(out), H, KH, D, max_pages * Pg, G::kKeys, n_splits);
  return cudaGetLastError();
}

// bf16 K1 at head_dim D and `split` keys per block (64, 128 or 256:
// 16, 32 or 64 keys per warp); anything else is cudaErrorInvalidValue.
template <int D>
cudaError_t launch_bf16_sm90(const void* q, const void* pages_k,
                             const void* pages_v, const void* page_table,
                             const void* positions, void* out,
                             void* part_acc, void* part_m, void* part_l,
                             int B, int H, int KH, int n_pages, int Pg,
                             int max_pages, int split, cudaStream_t stream) {
#define RTT_SM90(KW)                                                       \
  return launch_sm90<D, KW>(q, pages_k, pages_v, page_table, positions,   \
                            out, part_acc, part_m, part_l, B, H, KH,      \
                            n_pages, Pg, max_pages, stream)
  if (split == 64) RTT_SM90(16);
  if (split == 128) RTT_SM90(32);
  if (split == 256) RTT_SM90(64);
#undef RTT_SM90
  return cudaErrorInvalidValue;
}

}  // namespace
