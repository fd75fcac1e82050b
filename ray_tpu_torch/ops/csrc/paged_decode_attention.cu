// Paged-KV decode attention for Hopper (sm_90a): one decode query per
// slot against that slot's pages of the head-major pool.
//
// Replaces the TPU kernel ray_tpu/ops/paged_attention.py::_kernel
// (body _attend_page), launched by paged_decode_attention there. Same
// function: head h uses kv head h / (H / KH); slot b sees keys at
// logical positions 0..positions[b]; fp32 softmax and fp32
// accumulation; output in q's type. A slot with no visible key gives
// zeros, as the TPU kernel's m_safe / l floor do.
//
// Bound: device memory. Per layer the kernel must read each visible
// key and value once, 2 * sum_b(pos_b + 1) * KH * D * sizeof(T) bytes,
// and does 4 * rep flops per element pair of K and V it reads
// (rep <= 8), far below the ~295 flop/byte at which the H100's tensor
// cores would become the limit. So the design moves only the bytes it
// needs and keeps enough of them in flight:
//   - split-K (flash-decoding): one block per (slot, kv head, split of
//     `split` keys); the block serves the rep query heads of its group,
//     so every key and value is read once for all of them. The TPU
//     grid instead walks every one of max_pages pages in order for each
//     slot; here the splits of all slots run in parallel over the 132
//     SMs, and splits past positions[b] exit at once. A second, small
//     kernel merges the splits' (max, sum, unnormalised output);
//   - a block reads each page id from the page table itself and stages
//     tiles of at most one page in shared memory with 16-byte loads,
//     neighbouring threads on neighbouring addresses; rows are padded
//     so that the score pass reads them without bank conflicts;
//   - scores: kThreads / TT threads per key, each taking 16-byte chunks
//     of head_dim, reduced with one or two shuffles; softmax: one warp
//     per query row; PV: one thread per (query row, d).
// Not yet done (a later change): cp.async/TMA double buffering of the
// tiles, tensor-core products, and CUDA graphs around the decode step.
//
// Plain C interface, bound with ctypes by ray_tpu_torch/ops/_build.py
// and ray_tpu_torch/ops/paged_attention.py. The launch returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// 16 bytes of T as floats.
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

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
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
};

// One (slot, kv head, split): unnormalised softmax-weighted sum of the
// split's values for each query row of the group, with the split's max
// score m and sum of exp(score - m) l.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) split_kernel(
    const T* __restrict__ q, const T* __restrict__ pages_k,
    const T* __restrict__ pages_v, const int* __restrict__ page_table,
    const int* __restrict__ positions, float* __restrict__ part_acc,
    float* __restrict__ part_m, float* __restrict__ part_l, int H, int KH,
    int n_pages, int Pg, int max_pages, int split, float scale) {
  using G = Tile<T, D>;
  constexpr int TT = G::kKeys;
  constexpr int TPK = G::kTPK;
  constexpr int CE = Chunk<T>::kElems;
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

  // Keys 0..pos, but none past the page-table window; this split
  // covers [k0, k1).
  const int n_keys = min(positions[b] + 1, max_pages * Pg);
  const int k0 = s * split;
  if (k0 >= n_keys) return;  // uniform over the block
  const int k1 = min(k0 + split, n_keys);

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
    const size_t base =
        ((static_cast<size_t>(kh) * n_pages + pt[p]) * Pg + off) * D;
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
    const T* vrow = reinterpret_cast<const T*>(v_s);
    for (int t = 0; t < nt; ++t) {
      const float vv =
          to_float(vrow[t * (G::kPadRowBytes / static_cast<int>(sizeof(T))) +
                        d]);
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int r = rg + RG * j;
        if (r < rep) acc[j] += p_s[r][t] * vv;
      }
    }
    __syncthreads();  // the next tile overwrites k_s, v_s and p_s
    key += nt;
  }

  const size_t slot =
      (static_cast<size_t>(b) * KH + kh) * gridDim.z + s;
#pragma unroll
  for (int j = 0; j < RJ; ++j) {
    const int r = rg + RG * j;
    if (r < rep) part_acc[(slot * rep + r) * D + d] = acc[j];
  }
  if (tid < rep) {
    part_m[slot * rep + tid] = m_s[tid];
    part_l[slot * rep + tid] = l_s[tid];
  }
}

// Merge the splits of one (slot, kv head): out = sum_s acc_s e^(m_s-M)
// / sum_s l_s e^(m_s-M). No visible key gives zeros.
template <typename T>
__global__ void __launch_bounds__(kThreads) merge_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_m,
    const float* __restrict__ part_l, const int* __restrict__ positions,
    T* __restrict__ out, int H, int KH, int D, int max_keys, int split,
    int n_splits) {
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int rep = H / KH;
  const int n_keys = min(positions[b] + 1, max_keys);
  const int ns = n_keys > 0 ? (n_keys + split - 1) / split : 0;
  const size_t first = (static_cast<size_t>(b) * KH + kh) * n_splits;
  for (int i = threadIdx.x; i < rep * D; i += blockDim.x) {
    const int r = i / D;
    const int d = i - r * D;
    // unrolled so that several splits' loads are in flight at once
    float m = -1e30f;
#pragma unroll 8
    for (int s = 0; s < ns; ++s)
      m = fmaxf(m, part_m[(first + s) * rep + r]);
    float l = 0.f;
    float o = 0.f;
#pragma unroll 8
    for (int s = 0; s < ns; ++s) {
      const float w = expf(part_m[(first + s) * rep + r] - m);
      l += part_l[(first + s) * rep + r] * w;
      o += part_acc[((first + s) * rep + r) * D + d] * w;
    }
    out[(static_cast<size_t>(b) * H + static_cast<size_t>(kh) * rep + r) *
            D +
        d] = from_float<T>(o / fmaxf(l, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* pages_k, const void* pages_v,
                   const void* page_table, const void* positions, void* out,
                   void* part_acc, void* part_m, void* part_l, int B, int H,
                   int KH, int n_pages, int Pg, int max_pages, int split,
                   cudaStream_t stream) {
  const int n_splits = (max_pages * Pg + split - 1) / split;
  const dim3 grid(B, KH, n_splits);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  split_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pages_k),
      static_cast<const T*>(pages_v), static_cast<const int*>(page_table),
      static_cast<const int*>(positions), static_cast<float*>(part_acc),
      static_cast<float*>(part_m), static_cast<float*>(part_l), H, KH,
      n_pages, Pg, max_pages, split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<T><<<dim3(B, KH), kThreads, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_m),
      static_cast<const float*>(part_l), static_cast<const int*>(positions),
      static_cast<T*>(out), H, KH, D, max_pages * Pg, split, n_splits);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Pointers are device pointers of
// contiguous tensors: q and out [B, H, D], pages [KH, n_pages, Pg, D],
// page_table [B, max_pages] int32, positions [B] int32, and fp32
// scratch part_acc [B, KH, n_splits, H/KH, D], part_m and part_l
// [B, KH, n_splits, H/KH] with n_splits = ceil(max_pages * Pg / split).
// Returns a cudaError_t; cudaErrorInvalidValue for shapes the kernel
// does not take (the Python wrapper checks them first).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* pages_k, const void* pages_v,
    const void* page_table, const void* positions, void* out,
    void* part_acc, void* part_m, void* part_l, int B, int H, int KH, int D,
    int n_pages, int Pg, int max_pages, int split, int dtype,
    void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || H / KH < 1 ||
      H / KH > kMaxRep || n_pages <= 0 || Pg <= 0 || max_pages <= 0 ||
      split <= 0 || KH > 65535 ||
      (max_pages * Pg + split - 1) / split > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RTT_LAUNCH(T, DD)                                                    \
  return launch<T, DD>(q, pages_k, pages_v, page_table, positions, out,      \
                       part_acc, part_m, part_l, B, H, KH, n_pages, Pg,      \
                       max_pages, split, s)
  if (dtype == 0 && D == 64) RTT_LAUNCH(float, 64);
  if (dtype == 0 && D == 128) RTT_LAUNCH(float, 128);
  if (dtype == 1 && D == 64) RTT_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) RTT_LAUNCH(__nv_bfloat16, 128);
#undef RTT_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* paged_decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
