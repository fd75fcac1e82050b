// Flash attention for Hopper (sm_90a): the forward (K3) and the two
// backward kernels (K4: dQ, K5: dK and dV) of blockwise attention over
// the [B, T, H, D] layout, with an fp32 online softmax.
//
// Replaces the TPU kernels of ray_tpu/ops/flash_attention.py:
//   fwd_kernel     <- _fwd_kernel     (launched by _flash_fwd)
//   bwd_dq_kernel  <- _bwd_dq_kernel  (launched by _flash_bwd_packed)
//   bwd_dkv_kernel <- _bwd_dkv_kernel (launched by _flash_bwd_packed)
// Same functions and the same rounding points: scores in fp32 from the
// operand type, scaled after the dot product; masked scores -1e30; the
// row sum l floored at 1e-30; P (and dS) rounded to the operand type
// before the products that consume them; delta = rowsum(dO * O) in
// fp32, computed in-kernel; fp32 accumulation; outputs in the operand
// type. lse = m + log(l) is stored [B, H, T] fp32.
//
// Bound: device memory at the GPT-2 shape (every input read once, every
// output written once: ~0.05-0.08 ms per call at 3.35 TB/s, above the
// tensor-core time of the 4-8 * D flops per visible (query, key) pair).
// This first design is simple and right, not fast: products are scalar
// fp32 FMAs from shared memory (no tensor cores), so it is bound by the
// SM's FMA and shared-memory issue rate, far above the memory bound.
// What it does keep from the TPU design: scores and probabilities never
// leave the SM, causal tiles above the diagonal are never visited, and
// each output tile has exactly one owning block, so there are no atomics
// and the results are deterministic.
//   - K3 and K4: one block per (q tile of 64 rows, head, batch), a loop
//     over kv tiles of 64 keys (under causal, up to the diagonal tile).
//   - K5: one block per (kv tile of 64 keys, head, batch), a loop over q
//     tiles (under causal, from the diagonal tile on).
//   - 128 threads; in a 64 x 64 tile product thread t owns rows
//     8 * (t / 16) .. + 7 and columns (t % 16) + 16 j, so a row's 16
//     owners are one half-warp and row reductions are 4 shuffles.
//   - Tiles are staged in shared memory as fp32 with rows padded to
//     D + 1 floats, so the 16 rows a half-warp reads sit on 16 banks.
// Inputs are read through their strides (batch, row, head; the last
// dimension must be contiguous), so q, k and v may be the strided
// column views of one fused qkv projection.
// Not yet done (a later change): mma/wgmma tensor-core products, TMA or
// cp.async double buffering, a persistent schedule.
//
// Plain C interface, bound with ctypes by ray_tpu_torch/ops/_build.py
// and ray_tpu_torch/ops/flash_attention.py. Each launch returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kRows = 8;       // tile rows per thread
constexpr int kCols = 4;       // score columns per thread (64 / 16)
constexpr int kPLD = kBK + 1;  // padded row of a score tile

struct Strides {
  long long b, t, h;
};

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

// x rounded to T and back: the cast the reference applies before a
// product whose other operand is of type T.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Reductions over the 16 lanes of a half-warp.
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ const void* at(const void* base, size_t elem,
                                          const Strides& s, int b, int t,
                                          int h) {
  return static_cast<const char*>(base) +
         (b * s.b + static_cast<long long>(t) * s.t + h * s.h) * elem;
}

// Rows [row0, row0 + 64) of head h, batch b, into a [64][D + 1] fp32
// tile; neighbouring threads read neighbouring elements of a row.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          const Strides& s, int b,
                                          int row0, int h) {
  const T* base = static_cast<const T*>(at(src, sizeof(T), s, b, row0, h));
  for (int i = threadIdx.x; i < 64 * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r * (D + 1) + c] = to_float(base[r * s.t + c]);
  }
}

// delta[r] = sum_d dO[r, d] * O[r, d] (fp32) and the saved lse of the
// 64 query rows from q0: one warp per row.
template <typename T, int D>
__device__ __forceinline__ void row_stats(float* delta_s, float* lse_s,
                                          const float* dOs, const T* o,
                                          const Strides& so,
                                          const float* lse, int b, int q0,
                                          int h, int H, int T_q) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* base = static_cast<const T*>(at(o, sizeof(T), so, b, q0, h));
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    float acc = 0.f;
    for (int d = lane; d < D; d += 32)
      acc += dOs[r * (D + 1) + d] * to_float(base[r * so.t + d]);
    acc = warp_sum(acc);
    if (lane == 0) {
      delta_s[r] = acc;
      lse_s[r] = lse[(static_cast<size_t>(b) * H + h) * T_q + q0 + r];
    }
  }
}

// --------------------------------------------------------------------
// K3: forward. O = softmax(scale * Q K^T) V, and lse per query row.
// --------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    Strides sq, Strides sk, Strides sv, Strides so, int T_q, int T_k, int H,
    int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;  // [kBQ][kPLD]

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kBQ;
  const int rg = threadIdx.x / 16;
  const int cg = threadIdx.x % 16;

  load_tile<T, D>(Qs, q, sq, b, q0, h);

  float m[kRows], l[kRows], acc[kRows][NJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // causal (T_q == T_k, kBQ == kBK): kv tiles 0..qt; tile qt is the
  // diagonal one, the only one with masked scores
  const int n_kv = causal ? qt + 1 : T_k / kBK;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's Ks, Vs and Ps are consumed
    load_tile<T, D>(Ks, k, sk, b, k0, h);
    load_tile<T, D>(Vs, v, sv, b, k0, h);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kk[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kk[j] = Ks[(cg + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float qq = Qs[(rg * kRows + i) * LD + d];
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qq, kk[j], s[i][j]);
      }
    }

    const bool diag = causal && kt == qt;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = rg * kRows + i;
      float mx = -1e30f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] *= scale;
        if (diag && cg + 16 * j > r) s[i][j] = -1e30f;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[r * kPLD + cg + 16 * j] = round_to<T>(p);
      }
      sum = half_sum(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P V
#pragma unroll 4
    for (int t = 0; t < kBK; ++t) {
      float vv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[t * LD + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = Ps[(rg * kRows + i) * kPLD + t];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = rg * kRows + i;
    const float ls = fmaxf(l[i], 1e-30f);
    T* orow = static_cast<T*>(const_cast<void*>(
        at(o, sizeof(T), so, b, q0 + r, h)));
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      orow[cg + 16 * j] = from_float<T>(acc[i][j] / ls);
    if (cg == 0)
      lse[(static_cast<size_t>(b) * H + h) * T_q + q0 + r] =
          m[i] + logf(ls);
  }
}

// --------------------------------------------------------------------
// K4: dQ = scale * sum_kv (P o (dP - delta)) K, P = exp(scale Q K^T -
// lse), dP = dO V^T.
// --------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ o,
    const T* __restrict__ dout, const float* __restrict__ lse,
    T* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides so,
    Strides sdo, Strides sdq, int T_q, int T_k, int H, int causal,
    float scale) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kBQ * LD;
  float* Ks = dOs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* dSs = Vs + kBK * LD;  // [kBQ][kPLD]
  float* delta_s = dSs + kBQ * kPLD;
  float* lse_s = delta_s + kBQ;

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kBQ;
  const int rg = threadIdx.x / 16;
  const int cg = threadIdx.x % 16;

  load_tile<T, D>(Qs, q, sq, b, q0, h);
  load_tile<T, D>(dOs, dout, sdo, b, q0, h);
  __syncthreads();
  row_stats<T, D>(delta_s, lse_s, dOs, o, so, lse, b, q0, h, H, T_q);

  float acc[kRows][NJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int n_kv = causal ? qt + 1 : T_k / kBK;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // delta_s/lse_s written; previous Ks, dSs consumed
    load_tile<T, D>(Ks, k, sk, b, k0, h);
    load_tile<T, D>(Vs, v, sv, b, k0, h);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float kk[kCols], vv[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        kk[j] = Ks[(cg + 16 * j) * LD + d];
        vv[j] = Vs[(cg + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float qq = Qs[(rg * kRows + i) * LD + d];
        const float gg = dOs[(rg * kRows + i) * LD + d];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qq, kk[j], s[i][j]);
          dp[i][j] = fmaf(gg, vv[j], dp[i][j]);
        }
      }
    }

    const bool diag = causal && kt == qt;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = rg * kRows + i;
      const float lr = lse_s[r];
      const float dr = delta_s[r];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        float sc = s[i][j] * scale;
        if (diag && cg + 16 * j > r) sc = -1e30f;
        const float p = expf(sc - lr);
        dSs[r * kPLD + cg + 16 * j] = round_to<T>(p * (dp[i][j] - dr));
      }
    }
    __syncthreads();

    // acc += dS K
#pragma unroll 4
    for (int t = 0; t < kBK; ++t) {
      float kk[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kk[j] = Ks[t * LD + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float g = dSs[(rg * kRows + i) * kPLD + t];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(g, kk[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    T* row = static_cast<T*>(const_cast<void*>(
        at(dq, sizeof(T), sdq, b, q0 + rg * kRows + i, h)));
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      row[cg + 16 * j] = from_float<T>(acc[i][j] * scale);
  }
}

// --------------------------------------------------------------------
// K5: dV = sum_q P^T dO, dK = scale * sum_q dS^T Q, dS = P o (dP -
// delta). Scores are formed transposed (kv rows, q columns), so the
// block's threads own kv rows throughout.
// --------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ o,
    const T* __restrict__ dout, const float* __restrict__ lse,
    T* __restrict__ dk, T* __restrict__ dv, Strides sq, Strides sk,
    Strides sv, Strides so, Strides sdo, Strides sdk, Strides sdv, int T_q,
    int T_k, int H, int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBK * LD;
  float* Qs = Vs + kBK * LD;
  float* dOs = Qs + kBQ * LD;
  float* Pt = dOs + kBQ * LD;  // [kBK][kPLD]: P^T, rounded to T
  float* dSt = Pt + kBK * kPLD;  // [kBK][kPLD]: dS^T, rounded to T
  float* delta_s = dSt + kBK * kPLD;
  float* lse_s = delta_s + kBQ;

  const int kt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kt * kBK;
  const int rg = threadIdx.x / 16;
  const int cg = threadIdx.x % 16;

  load_tile<T, D>(Ks, k, sk, b, k0, h);
  load_tile<T, D>(Vs, v, sv, b, k0, h);

  float gk[kRows][NJ], gv[kRows][NJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) gk[i][j] = gv[i][j] = 0.f;

  // causal: only q tiles at or after this kv tile see its keys
  const int n_q = T_q / kBQ;
  for (int qt = causal ? kt : 0; qt < n_q; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();  // the previous q tile's Qs, dOs, Pt, dSt consumed
    load_tile<T, D>(Qs, q, sq, b, q0, h);
    load_tile<T, D>(dOs, dout, sdo, b, q0, h);
    __syncthreads();
    row_stats<T, D>(delta_s, lse_s, dOs, o, so, lse, b, q0, h, H, T_q);
    __syncthreads();

    float st[kRows][kCols], dpt[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qq[kCols], gg[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        qq[j] = Qs[(cg + 16 * j) * LD + d];
        gg[j] = dOs[(cg + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float kk = Ks[(rg * kRows + i) * LD + d];
        const float vv = Vs[(rg * kRows + i) * LD + d];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          st[i][j] = fmaf(kk, qq[j], st[i][j]);
          dpt[i][j] = fmaf(vv, gg[j], dpt[i][j]);
        }
      }
    }

    const bool diag = causal && qt == kt;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = rg * kRows + i;  // key k0 + r
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = cg + 16 * j;  // query q0 + c
        float sc = st[i][j] * scale;
        if (diag && r > c) sc = -1e30f;
        const float p = expf(sc - lse_s[c]);
        Pt[r * kPLD + c] = round_to<T>(p);
        dSt[r * kPLD + c] = round_to<T>(p * (dpt[i][j] - delta_s[c]));
      }
    }
    __syncthreads();

    // gv += P^T dO, gk += dS^T Q
#pragma unroll 2
    for (int t = 0; t < kBQ; ++t) {
      float qq[NJ], gg[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        qq[j] = Qs[t * LD + cg + 16 * j];
        gg[j] = dOs[t * LD + cg + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = Pt[(rg * kRows + i) * kPLD + t];
        const float g = dSt[(rg * kRows + i) * kPLD + t];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          gv[i][j] = fmaf(p, gg[j], gv[i][j]);
          gk[i][j] = fmaf(g, qq[j], gk[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = k0 + rg * kRows + i;
    T* krow = static_cast<T*>(const_cast<void*>(at(dk, sizeof(T), sdk, b, r, h)));
    T* vrow = static_cast<T*>(const_cast<void*>(at(dv, sizeof(T), sdv, b, r, h)));
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      krow[cg + 16 * j] = from_float<T>(gk[i][j] * scale);
      vrow[cg + 16 * j] = from_float<T>(gv[i][j]);
    }
  }
}

// Shared memory of each kernel, in floats.
template <int D>
constexpr int fwd_smem() {
  return 3 * 64 * (D + 1) + kBQ * kPLD;
}
template <int D>
constexpr int dq_smem() {
  return 4 * 64 * (D + 1) + kBQ * kPLD + 2 * kBQ;
}
template <int D>
constexpr int dkv_smem() {
  return 4 * 64 * (D + 1) + 2 * kBK * kPLD + 2 * kBQ;
}

template <typename K>
cudaError_t allow_smem(K kernel, int floats) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              floats * static_cast<int>(sizeof(float)));
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, const long long* s, int B, int T_q,
                       int T_k, int H, int causal, float scale,
                       cudaStream_t stream) {
  auto kernel = fwd_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, fwd_smem<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(T_q / kBQ, H, B), kThreads, fwd_smem<D>() * sizeof(float),
           stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), static_cast<T*>(o), lse,
                     strides_at(s, 0), strides_at(s, 1), strides_at(s, 2),
                     strides_at(s, 3), T_q, T_k, H, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      void* dq, const long long* s, int B, int T_q, int T_k,
                      int H, int causal, float scale, cudaStream_t stream) {
  auto kernel = bwd_dq_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, dq_smem<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(T_q / kBQ, H, B), kThreads, dq_smem<D>() * sizeof(float),
           stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), static_cast<const T*>(o),
                     static_cast<const T*>(dout), lse, static_cast<T*>(dq),
                     strides_at(s, 0), strides_at(s, 1), strides_at(s, 2),
                     strides_at(s, 3), strides_at(s, 4), strides_at(s, 5),
                     T_q, T_k, H, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       void* dk, void* dv, const long long* s, int B,
                       int T_q, int T_k, int H, int causal, float scale,
                       cudaStream_t stream) {
  auto kernel = bwd_dkv_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, dkv_smem<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(T_k / kBK, H, B), kThreads, dkv_smem<D>() * sizeof(float),
           stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), static_cast<const T*>(o),
                     static_cast<const T*>(dout), lse, static_cast<T*>(dk),
                     static_cast<T*>(dv), strides_at(s, 0), strides_at(s, 1),
                     strides_at(s, 2), strides_at(s, 3), strides_at(s, 4),
                     strides_at(s, 5), strides_at(s, 6), T_q, T_k, H, causal,
                     scale);
  return cudaGetLastError();
}

bool shape_ok(int B, int T_q, int T_k, int H, int causal) {
  return B > 0 && H > 0 && T_q > 0 && T_k > 0 && T_q % kBQ == 0 &&
         T_k % kBK == 0 && (!causal || T_q == T_k) && B <= 65535 &&
         H <= 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D: 64 or 128. Pointers are device
// pointers; `strides` is a host array of (batch, row, head) element
// strides, three per tensor in argument order (the last dimension of
// every tensor is contiguous); lse is a contiguous [B, H, T_q] fp32
// tensor. Causal needs T_q == T_k. Returns a cudaError_t,
// cudaErrorInvalidValue for shapes the kernels do not take (the Python
// wrapper checks them first).
#define RTT_DISPATCH(CALL)                                                  \
  if (dtype == 0 && D == 64) return static_cast<int>(CALL(float, 64));      \
  if (dtype == 0 && D == 128) return static_cast<int>(CALL(float, 128));    \
  if (dtype == 1 && D == 64)                                                \
    return static_cast<int>(CALL(__nv_bfloat16, 64));                       \
  if (dtype == 1 && D == 128)                                               \
    return static_cast<int>(CALL(__nv_bfloat16, 128));                      \
  return static_cast<int>(cudaErrorInvalidValue)

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, const long long* strides,
                                int B, int T_q, int T_k, int H, int D,
                                int causal, float scale, int dtype,
                                void* stream) {
  if (!shape_ok(B, T_q, T_k, H, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RTT_FWD(T, DD)                                                      \
  launch_fwd<T, DD>(q, k, v, o, static_cast<float*>(lse), strides, B, T_q, \
                    T_k, H, causal, scale, st)
  RTT_DISPATCH(RTT_FWD);
#undef RTT_FWD
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* dq, const long long* strides, int B,
                                   int T_q, int T_k, int H, int D,
                                   int causal, float scale, int dtype,
                                   void* stream) {
  if (!shape_ok(B, T_q, T_k, H, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RTT_DQ(T, DD)                                                      \
  launch_dq<T, DD>(q, k, v, o, dout, static_cast<const float*>(lse), dq,  \
                   strides, B, T_q, T_k, H, causal, scale, st)
  RTT_DISPATCH(RTT_DQ);
#undef RTT_DQ
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* dout, const void* lse,
                                    void* dk, void* dv,
                                    const long long* strides, int B,
                                    int T_q, int T_k, int H, int D,
                                    int causal, float scale, int dtype,
                                    void* stream) {
  if (!shape_ok(B, T_q, T_k, H, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RTT_DKV(T, DD)                                                      \
  launch_dkv<T, DD>(q, k, v, o, dout, static_cast<const float*>(lse), dk, \
                    dv, strides, B, T_q, T_k, H, causal, scale, st)
  RTT_DISPATCH(RTT_DKV);
#undef RTT_DKV
}

#undef RTT_DISPATCH

extern "C" const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
