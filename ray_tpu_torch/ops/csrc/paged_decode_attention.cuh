// Paged-KV decode attention for Hopper (sm_90a): the scalar split pass
// of fp32 K1 (paged_decode_attention.cu: fp32 pages) and of fp32-q K2
// (paged_decode_attention_int8.cu: int8 pages with per-page fp32
// scales), and the merge that ends every split pass, this one's and the
// tensor-core split_sm90's (paged_decode_attention_sm90.cuh, which bf16
// K1 and bf16-q K2 run): one decode query per slot against that slot's
// pages of the head-major pool. Each .cu file instantiates the
// templates for its page type and exports its plain C entry; the two
// are built by one nvcc each, in parallel.
//
// Function: head h uses kv head h / (H / KH); slot b sees keys at
// logical positions 0..positions[b]; fp32 softmax and fp32
// accumulation; output in q's type. A slot with no visible key gives
// zeros, as the TPU kernels' m_safe / l floor do. For int8 pages the
// page type is a template parameter separate from q's type; a block
// reads the page's scale through the same page_table entry it reads
// the page with (a tile never crosses a page, so one scale per tile),
// stages the int8 bytes themselves in shared memory, and dequantizes
// in registers in the TPU kernel's order, float(q8) * (s * (1/127)).
//
// Bound: device memory. Per layer the kernel must read each visible
// key and value once, 2 * sum_b(pos_b + 1) * KH * D * sizeof(page)
// bytes (int8: half of bf16's, plus 2 * 4 * KH bytes of scales per
// visible page), and does 4 * rep flops per element pair of K and V it
// reads (rep <= 8), far below the ~295 flop/byte at which the H100's
// tensor cores would become the limit. So the design moves only the
// bytes it needs and keeps enough of them in flight:
//   - split-K (flash-decoding): one block per (slot, kv head, split of
//     `split` keys); the block serves the rep query heads of its group,
//     so every key and value is read once for all of them. The TPU
//     grid instead walks every one of max_pages pages in order for each
//     slot; here the splits of all slots run in parallel over the 132
//     SMs, and splits past positions[b] exit at once;
//   - a block reads each page id from the page table itself and stages
//     tiles of at most one page in shared memory with 16-byte loads,
//     neighbouring threads on neighbouring addresses; rows are padded
//     so that the score pass reads them without bank conflicts;
//   - scores: kThreads / TT threads per key, each taking 16-byte chunks
//     of head_dim, reduced with one or two shuffles; softmax: one warp
//     per query row; PV: one thread per (query row, d).
// The block's serial score, softmax and PV phases, not bytes, set its
// pace; the tensor-core pass removes them for bf16 q. ptxas (-Xptxas
// -v, nvcc 12.9, sm_90a; the report beside each built library):
// split_kernel<float, float, 64> 127 registers and 41,056 bytes of
// static shared memory, <float, float, 128> 128 and 42,080,
// <float, int8_t, 64> 128 and 16,480, <float, int8_t, 128> 128 and
// 26,720; no spills.
//
// The merge (merge_tail), one launch per call: a slot with one live
// split writes its output straight from the split block. Otherwise
// every split block writes its partial (unnormalised O, max m, sum l)
// and takes a ticket (an acq_rel atomic) on its (slot, kv head)'s
// int32 counter; the block that draws the last ticket resets the
// counter to 0 and merges every live split's partial, read from L2
// (__ldcg): all splits' (m, l) and the first round of partials are
// loaded at once, each row's (M, L) and the splits' weights come from
// the (m, l) by 16 threads a row, then every (row, d) takes its
// partials in split order, kMergeLoads values a thread a round. The
// order of every sum is fixed, so a call's result does not depend on
// which block merges: repeated calls are bitwise equal.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 8;
// partial values a merging thread loads in one round (8 splits of its
// 4 (row, d) at D 64, 4 of 8 at D 128; a 2048-key window has 8, 16 or
// 32 splits of 256, 128 or 64 keys), and splits whose weights the merge
// keeps in shared memory
constexpr int kMergeLoads = 32;
constexpr int kMergeMax = 64;
// floats of shared scratch merge_tail needs: weights, row max and sum,
// the last-ticket flag
constexpr int kMergeScratch = kMergeMax * kMaxRep + 2 * kMaxRep + 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16 bytes of T as floats (4 fp32 or 16 int8 values).
template <typename T>
struct Chunk {
  static constexpr int kElems = 16 / static_cast<int>(sizeof(T));
};

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[16]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)  // little-endian: byte j is element 4i+j
      f[4 * i + j] = static_cast<float>(
          static_cast<int8_t>(static_cast<uint8_t>(w[i] >> (8 * j))));
  }
}

// Keys 0..positions[b], clipped to the page-table window, and the
// number of `split`-key splits that hold any of them.
struct Visible {
  int keys;
  int splits;
};

__device__ __forceinline__ Visible visible(int pos, int window,
                                           int split) {
  const int n = min(pos + 1, window);
  return {n, n > 0 ? (n + split - 1) / split : 0};
}

// Zeros for the rep rows of a (slot, kv head) with no visible key:
// written by its split-0 block, since every split block exits.
template <typename T>
__device__ __forceinline__ void write_zeros(T* __restrict__ out, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads)
    out[i] = from_float<T>(0.f);
}

// A ticket on a counter: the release orders the block's stores before
// it (after a barrier), the acquire the other blocks' stores after it.
__device__ __forceinline__ int take_ticket(int* counter) {
  int ticket;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(ticket)
               : "l"(counter)
               : "memory");
  return ticket;
}

// The tail of every split pass when its (slot, kv head) has live > 1
// splits, called by all kThreads threads after the block has written
// its partial for split slot `first + s` (part_acc [.., rep, D],
// part_m / part_l [.., rep], splits of one (slot, kv head) adjacent
// from `first`). The block that draws the last ticket of `counter`
// resets it and writes out[r * D + d] = sum_s acc_s e^(m_s - M) /
// sum_s l_s e^(m_s - M) for the rep rows; every other block returns.
// `scratch` is kMergeScratch floats of shared memory that no thread
// reads any more.
template <typename T, int D>
__device__ __forceinline__ void merge_tail(
    const float* __restrict__ part_acc, const float* __restrict__ part_m,
    const float* __restrict__ part_l, int* __restrict__ counter,
    size_t first, int live, int rep, T* __restrict__ out, float* scratch) {
  constexpr int RJ = kMaxRep * D / kThreads;   // (row, d) per thread
  constexpr int NS = kMergeLoads / RJ;          // splits per round
  float* wgt = scratch;                        // [split][rep]
  float* row_m = scratch + kMergeMax * kMaxRep;
  float* row_l = row_m + kMaxRep;
  int* last = reinterpret_cast<int*>(row_l + kMaxRep);
  const int tid = threadIdx.x;

  // The block's partial stores come before the ticket: the barrier
  // orders them before thread 0's release, which covers them all.
  __syncthreads();
  if (tid == 0) {
    const int ticket = take_ticket(counter);
    *last = ticket == live - 1;
    if (ticket == live - 1) *counter = 0;   // ready for the next call
  }
  __syncthreads();
  if (!*last) return;

  // Round c0 of the partials: NS splits' (row, d) values of this
  // thread, every load issued before any is used.
  const auto load_round = [&](int c0, float (&a)[RJ][NS]) {
    const int n = min(NS, live - c0);
    const float* pa = part_acc + (first + c0) * rep * D;
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const int i = tid + j * kThreads;
#pragma unroll
      for (int s = 0; s < NS; ++s)
        a[j][s] = s < n && i < rep * D
                      ? __ldcg(pa + static_cast<size_t>(s) * rep * D + i)
                      : 0.f;
    }
  };
  float o[RJ];
  const auto add_round = [&](const float (&a)[RJ][NS], const float* w) {
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const int r = min((tid + j * kThreads) / D, rep - 1);
#pragma unroll
      for (int s = 0; s < NS; ++s) o[j] += a[j][s] * w[s * rep + r];
    }
  };

  // 1. Each row's (M, L) over all live splits and the weights
  //    e^(m_s - M) of the first kMergeMax: 16 threads a row, each over
  //    its splits, reduced in a fixed shuffle tree. The (m, l) loads go
  //    first, then round 0 of the partials, so that both are in flight
  //    at once.
  const int r = tid >> 4;
  const int i16 = tid & 15;
  float mv[kMergeMax / 16], lv[kMergeMax / 16];
#pragma unroll
  for (int u = 0; u < kMergeMax / 16; ++u) {
    const int s = i16 + 16 * u;
    const bool in = r < rep && s < live;
    mv[u] = in ? __ldcg(part_m + (first + s) * rep + r) : -1e30f;
    lv[u] = in ? __ldcg(part_l + (first + s) * rep + r) : 0.f;
  }
  float a[RJ][NS];
  load_round(0, a);
  {
    // M first, then every weight at once: no chain of exponentials
    float m = -1e30f;
#pragma unroll
    for (int u = 0; u < kMergeMax / 16; ++u) m = fmaxf(m, mv[u]);
    if (r < rep)
      for (int s = i16 + kMergeMax; s < live; s += 16)
        m = fmaxf(m, __ldcg(part_m + (first + s) * rep + r));
#pragma unroll
    for (int lane = 8; lane > 0; lane >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, lane));
    float l = 0.f;
#pragma unroll
    for (int u = 0; u < kMergeMax / 16; ++u) {
      mv[u] = i16 + 16 * u < live ? expf(mv[u] - m) : 0.f;
      l += lv[u] * mv[u];
    }
    if (r < rep)
      for (int s = i16 + kMergeMax; s < live; s += 16)
        l += __ldcg(part_l + (first + s) * rep + r) *
             expf(__ldcg(part_m + (first + s) * rep + r) - m);
#pragma unroll
    for (int lane = 8; lane > 0; lane >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, lane);
    if (r < rep) {
#pragma unroll
      for (int u = 0; u < kMergeMax / 16; ++u)   // zero past the live splits
        wgt[(i16 + 16 * u) * rep + r] = mv[u];
      if (i16 == 0) {
        row_m[r] = m;
        row_l[r] = fmaxf(l, 1e-30f);
      }
    }
  }
  __syncthreads();

  // 2. out = sum_s acc_s w_s / L, in split order.
#pragma unroll
  for (int j = 0; j < RJ; ++j) o[j] = 0.f;
  add_round(a, wgt);
  for (int c0 = NS; c0 < live; c0 += NS) {
    load_round(c0, a);
    const float* w = wgt + c0 * rep;
    if (c0 + NS > kMergeMax) {  // past the kept weights
      const int n = min(NS, live - c0);
      __syncthreads();
      for (int i = tid; i < NS * rep; i += kThreads)
        wgt[i] = i < n * rep
                     ? expf(__ldcg(part_m + (first + c0) * rep + i) -
                            row_m[i % rep])
                     : 0.f;
      __syncthreads();
      w = wgt;
    }
    add_round(a, w);
  }
#pragma unroll
  for (int j = 0; j < RJ; ++j) {
    const int i = tid + j * kThreads;
    if (i < rep * D) out[i] = from_float<T>(o[j] / row_l[i / D]);
  }
}

// Tile geometry for one (type, head_dim): TT keys per tile, K and V
// tiles together at most 32 KB before padding; TPK threads per key in
// the score pass; rows padded by 16 * TPK bytes, which puts the TPK
// threads of the 8 lanes in one shared-memory phase on distinct banks.
template <typename T, int D>
struct Tile {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  static constexpr int kFit = 32768 / (2 * kRowBytes);
  static constexpr int kKeys = kFit < 64 ? kFit : 64;
  static constexpr int kTPK = kThreads / kKeys;
  static constexpr int kChunks = kRowBytes / 16;          // per row
  static constexpr int kPadRowBytes = kRowBytes + 16 * kTPK;
  static constexpr int kPadRowChunks = kPadRowBytes / 16;
  // merge_tail's scratch goes over the K tile
  static_assert(kKeys * kPadRowBytes >= kMergeScratch * 4, "scratch");
};

// One (slot, kv head, split): the softmax-weighted sum of the split's
// values for each query row of the group, with the split's max score m
// and sum of exp(score - m) l, then merge_tail. T is q's type, P the
// pages' (P = T for K1; int8_t for K2, which then reads
// scales_k/scales_v).
template <typename T, typename P, int D>
__global__ void __launch_bounds__(kThreads) split_kernel(
    const T* __restrict__ q, const P* __restrict__ pages_k,
    const P* __restrict__ pages_v, const float* __restrict__ scales_k,
    const float* __restrict__ scales_v, const int* __restrict__ page_table,
    const int* __restrict__ positions, T* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_m,
    float* __restrict__ part_l, int* __restrict__ counters, int H, int KH,
    int n_pages, int Pg, int max_pages, int split, float scale) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  using G = Tile<P, D>;
  constexpr int TT = G::kKeys;
  constexpr int TPK = G::kTPK;
  constexpr int CE = Chunk<P>::kElems;
  constexpr int RG = kThreads / D;             // query-row groups in PV
  constexpr int RJ = (kMaxRep + RG - 1) / RG;  // accumulator rows/thread

  __shared__ __align__(16) uint4 k_s[TT * G::kPadRowChunks];
  __shared__ __align__(16) uint4 v_s[TT * G::kPadRowChunks];
  __shared__ __align__(16) float q_s[kMaxRep][D];
  __shared__ float p_s[kMaxRep][TT];
  __shared__ float m_s[kMaxRep];
  __shared__ float l_s[kMaxRep];
  __shared__ float alpha_s[kMaxRep];

  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int s = blockIdx.z;
  const int rep = H / KH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  T* ob = out + (static_cast<size_t>(b) * H +
                 static_cast<size_t>(kh) * rep) * D;

  // Keys 0..pos, but none past the page-table window; this split
  // covers [k0, k1).
  const Visible vis = visible(positions[b], max_pages * Pg, split);
  const int k0 = s * split;
  if (k0 >= vis.keys) {  // uniform over the block
    if (s == 0) write_zeros(ob, rep * D);
    return;
  }
  const int k1 = min(k0 + split, vis.keys);

  const T* qb = q + (static_cast<size_t>(b) * H +
                     static_cast<size_t>(kh) * rep) * D;
  for (int i = tid; i < rep * D; i += kThreads)
    q_s[i / D][i % D] = to_float(qb[i]) * scale;
  if (tid < kMaxRep) {
    m_s[tid] = -1e30f;
    l_s[tid] = 0.f;
  }
  float acc[RJ];
#pragma unroll
  for (int j = 0; j < RJ; ++j) acc[j] = 0.f;
  const int* pt = page_table + static_cast<size_t>(b) * max_pages;
  const int d = tid % D;
  const int rg = tid / D;
  const int key_t = tid / TPK;   // score pass: this thread's key
  const int part = tid % TPK;    // and its share of head_dim
  __syncthreads();

  for (int key = k0; key < k1;) {
    // A tile never crosses a page: TT keys, the rest of the page, or
    // the rest of the split, whichever is least.
    const int p = key / Pg;
    const int off = key - p * Pg;
    const int nt = min(min(TT, Pg - off), k1 - key);
    const int page = pt[p];
    const size_t base =
        ((static_cast<size_t>(kh) * n_pages + page) * Pg + off) * D;
    // K2: the page's scales, through the same page-table entry, times
    // 1/127 first, as the TPU kernel does
    float sk = 1.f, sv = 1.f;
    if constexpr (kQuant) {
      const size_t si = static_cast<size_t>(kh) * n_pages + page;
      sk = scales_k[si] * (1.0f / 127.0f);
      sv = scales_v[si] * (1.0f / 127.0f);
    }
    const uint4* gk = reinterpret_cast<const uint4*>(pages_k + base);
    const uint4* gv = reinterpret_cast<const uint4*>(pages_v + base);
    for (int i = tid; i < nt * G::kChunks; i += kThreads) {
      const int row = i / G::kChunks;
      const int c = i - row * G::kChunks;
      k_s[row * G::kPadRowChunks + c] = gk[i];
      v_s[row * G::kPadRowChunks + c] = gv[i];
    }
    __syncthreads();

    // 1. Scores q.k: TPK threads per key, 16-byte chunks of head_dim
    //    taken round-robin, so the threads of one key read adjacent q
    //    chunks (broadcast over the keys) and distinct banks of K.
    //    Every lane runs the shuffles; lanes past the tile add zeros.
    {
      const bool live = key_t < nt;
      float sc[kMaxRep];
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) sc[r] = 0.f;
      if (live) {
        for (int c = part; c < G::kChunks; c += TPK) {
          float kf[CE];
          unpack(k_s[key_t * G::kPadRowChunks + c], kf);
          if constexpr (kQuant) {
#pragma unroll
            for (int e = 0; e < CE; ++e) kf[e] *= sk;
          }
#pragma unroll
          for (int r = 0; r < kMaxRep; ++r) {
            if (r < rep) {
#pragma unroll
              for (int e = 0; e < CE; ++e)
                sc[r] += q_s[r][c * CE + e] * kf[e];
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
#pragma unroll
        for (int o = 1; o < TPK; o <<= 1)
          sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], o);
        if (live && r < rep && part == 0) p_s[r][key_t] = sc[r];
      }
    }
    __syncthreads();

    // 2. Online softmax over the tile: one warp per query row.
    for (int r = warp; r < rep; r += kWarps) {
      float mx = -1e30f;
      for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, p_s[r][t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(fmaxf(m_prev, mx), -1e29f);
      float sum = 0.f;
      for (int t = lane; t < nt; t += 32) {
        const float e = expf(p_s[r][t] - m_new);
        p_s[r][t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha_s[r] = a;
        l_s[r] = l_s[r] * a + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // 3. acc = acc * alpha + P V: one thread per (query row, d).
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const int r = rg + RG * j;
      if (r < rep) acc[j] *= alpha_s[r];
    }
    const P* vrow = reinterpret_cast<const P*>(v_s);
    for (int t = 0; t < nt; ++t) {
      float vv =
          to_float(vrow[t * (G::kPadRowBytes / static_cast<int>(sizeof(P))) +
                        d]);
      if constexpr (kQuant) vv *= sv;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int r = rg + RG * j;
        if (r < rep) acc[j] += p_s[r][t] * vv;
      }
    }
    __syncthreads();  // the next tile overwrites k_s, v_s and p_s
    key += nt;
  }

  if (vis.splits == 1) {  // the whole window: normalise in place
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const int r = rg + RG * j;
      if (r < rep) ob[r * D + d] = from_float<T>(acc[j] /
                                                 fmaxf(l_s[r], 1e-30f));
    }
    return;
  }
  const size_t first = (static_cast<size_t>(b) * KH + kh) * gridDim.z;
  const size_t slot = first + s;
#pragma unroll
  for (int j = 0; j < RJ; ++j) {
    const int r = rg + RG * j;
    if (r < rep) part_acc[(slot * rep + r) * D + d] = acc[j];
  }
  if (tid < rep) {
    part_m[slot * rep + tid] = m_s[tid];
    part_l[slot * rep + tid] = l_s[tid];
  }
  merge_tail<T, D>(part_acc, part_m, part_l,
                   counters + static_cast<size_t>(b) * KH + kh, first,
                   vis.splits, rep, ob, reinterpret_cast<float*>(k_s));
}

template <typename T, typename P, int D>
cudaError_t launch(const void* q, const void* pages_k, const void* pages_v,
                   const void* scales_k, const void* scales_v,
                   const void* page_table, const void* positions, void* out,
                   void* part_acc, void* part_m, void* part_l,
                   void* counters, int B, int H, int KH, int n_pages,
                   int Pg, int max_pages, int split, cudaStream_t stream) {
  const int n_splits = (max_pages * Pg + split - 1) / split;
  const dim3 grid(B, KH, n_splits);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  split_kernel<T, P, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(pages_k),
      static_cast<const P*>(pages_v), static_cast<const float*>(scales_k),
      static_cast<const float*>(scales_v),
      static_cast<const int*>(page_table),
      static_cast<const int*>(positions), static_cast<T*>(out),
      static_cast<float*>(part_acc), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<int*>(counters), H, KH,
      n_pages, Pg, max_pages, split, scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int KH, int n_pages, int Pg, int max_pages,
               int split) {
  return B <= 0 || KH <= 0 || H % KH != 0 || H / KH < 1 ||
         H / KH > kMaxRep || n_pages <= 0 || Pg <= 0 || max_pages <= 0 ||
         split <= 0 || KH > 65535 ||
         (max_pages * Pg + split - 1) / split > 65535;
}

}  // namespace
