// Flash attention on Hopper's tensor cores (sm_90a), bf16: the forward
// (K3), the dQ backward (K4) and the dK/dV backward (K5) over the
// [B, T, H, D] layout, D 64 or 128, with an fp32 online softmax.
//
// Replaces, for bf16 inputs, the TPU kernels of
// ray_tpu/ops/flash_attention.py:
//   fwd_sm90 <- _fwd_kernel     (launched by _flash_fwd)
//   dq_sm90  <- _bwd_dq_kernel  (launched by _flash_bwd_packed)
//   dkv_sm90 <- _bwd_dkv_kernel (launched by _flash_bwd_packed)
// fp32 inputs stay on the scalar kernels of flash_attention.cu (tensor
// cores cannot hold fp32 to 1e-4).
// Same functions and rounding points as those kernels: fp32 scores from
// bf16 operands, scaled after the product; masked scores -1e30; the row
// sum l of the unrounded P, floored at 1e-30; P (and dS) rounded to
// bf16 before the products that consume them; delta = rowsum(dO * O) in
// fp32; fp32 accumulation; lse = m + log(l) stored [B, H, T] fp32.
// Exponentials are exp2f((x - m) * log2(e)), x the scaled score.
//
// Bound. At the GPT-2-124M shape (B 24, T 1024, H 12, D 64, causal) K3
// does 4 * D flops, K4 6 * D and K5 8 * D per visible (query, key)
// pair: 38.7, 58.1 and 77.4 GFLOP, 0.04, 0.06 and 0.08 ms at the 989
// TFLOP/s bf16 tensor-core peak, about the time the card needs to read
// the inputs once (0.05-0.08 ms at 3.35 TB/s). Scalar fp32 FMAs (67
// TFLOP/s) cannot go below 0.58, 0.87 and 1.16 ms, so every product
// here is a wgmma.
//
// Design (one CTA = one consumer warpgroup + one producer warp):
//   - The producer warp's first lane streams tiles with TMA into a ring
//     of kStages stages (full/empty mbarriers), so the next tile's copy
//     is in flight while the warpgroup computes on the current one. The
//     tensor maps carry the inputs' own strides (4-D: D, H, T, B), so q,
//     k and v may be the strided column views of a fused qkv projection.
//   - Tiles stay bf16 in shared memory, 64 rows of 64 columns per box
//     with the 128-byte swizzle that wgmma reads without bank conflicts
//     (D 128 is two boxes side by side).
//   - K3: a CTA owns 64 q rows; Q is loaded once and kept in registers
//     (ldmatrix) as the A operand of S = Q K^T, K read K-major from
//     shared memory; K and V stream. The online softmax runs on the
//     accumulator fragments (a row's four owners reduce with two
//     shuffles); P goes to bf16 in registers and is the A operand of
//     O += P V, V read MN-major (transposed by the instruction). Under
//     causal a CTA visits kv tiles up to its diagonal tile, the only
//     masked one.
//   - K4: a CTA owns 64 q rows, as in K3; Q and dO are loaded once and
//     kept in registers as the A operands of S = Q K^T and dP = dO V^T
//     (K and V read K-major; both products issued before the wait), K
//     and V stream. P and dS are formed on the accumulator fragments;
//     dS goes to bf16 in registers and is the A operand of dQ += dS K,
//     K read MN-major: K3's O += P V with K in V's place. dQ is scaled
//     once at the end. Under causal the kv tiles run as in K3.
//   - K5: a CTA owns 64 keys; K and V are loaded once, Q, dO and the q
//     tile's lse and delta stream. S^T = K Q^T and dP^T = V dO^T with
//     both operands in shared memory, then dV += P^T dO and dK += dS^T
//     Q with P^T and dS^T as register A operands; dK is scaled once at
//     the end. Under causal a CTA walks the q tiles from its diagonal
//     tile on.
//   - The CTAs of one (batch, head) are consecutive in the grid (under
//     causal, longest first), so the tiles they all stream (K and V in
//     K3 and K4; Q and dO in K5) come from device memory once and then
//     from L2 (in (tile, head, batch) order the resident CTAs' working
//     set outgrew the 50 MB L2 and the streams were re-read from device
//     memory).
//   - delta = rowsum(dO * O) is formed once per row by delta_kernel, its
//     own launch, and K4 and K5 of one backward read the same delta (the
//     TPU kernels recompute it for every block).
//   - Every output tile has one owner: no atomics, deterministic.
// A wait on an mbarrier that outlasts ~2^32 cycles traps (a launch
// error) rather than hanging the card.
//
// Plain C interface, bound with ctypes by ray_tpu_torch/ops/_build.py
// and ray_tpu_torch/ops/flash_attention.py. Each launch returns
// cudaGetLastError(); cuTensorMapEncodeTiled is reached through
// cudaGetDriverEntryPoint, so the library links nothing beyond cudart.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;                  // q rows and keys per tile
constexpr int kConsumers = 128;            // one warpgroup: the products
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kStages = 2;                 // ring depth
constexpr int kBox = kTile * 64 * 2;       // bytes of one 64 x 64 bf16 box
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, t, h;
};

// ---------------------------------------------------------------------
// PTX wrappers: shared-memory addresses, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 32)) __trap();
  }
}

// One 64 x 64 box of a 4-D (D, H, T, B) tensor map into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int d, int h, int t,
                                        int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h), "r"(t),
      "r"(b)
      : "memory");
}

// Rows [t, t + 64) of head h, batch b: D / 64 boxes, kBox bytes apart.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int b, int h, int t) {
#pragma unroll
  for (int half = 0; half < D / 64; ++half)
    tma_box(dst + half * kBox, map, bar, 64 * half, h, t, b);
}

// `bytes` contiguous bytes (a multiple of 16) into shared memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator
// registers across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// Columns [16 ks, 16 ks + 16) of a [64][D] tile as a K-major operand:
// 8-row groups 1024 bytes apart, the slice 32 bytes into its box's row.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int ks) {
  return desc(tile + (ks / 4) * kBox + (ks % 4) * 32, 16, 1024);
}

// Rows [16 ks, 16 ks + 16) of a [64][D] tile as an MN-major operand
// (K = rows): 8-row groups 1024 bytes apart, 64-column boxes kBox
// apart.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int ks) {
  return desc(tile + ks * 16 * 128, kBox, 1024);
}

// Columns [16 ks, 16 ks + 16) of this warp's 16 rows of a [64][D] bf16
// tile (64-column boxes with the 128-byte swizzle: 16-byte chunk c of
// row r lies at chunk c ^ (r % 8)) as a register A operand.
__device__ __forceinline__ void load_a(uint32_t tile, int ks,
                                       uint32_t (&a)[4]) {
  const int lane = threadIdx.x % 32;
  const int row = 16 * (threadIdx.x / 32 % 4) + lane % 16;
  const int col = 16 * ks + 8 * (lane / 16);
  const uint32_t addr = tile + (col / 64) * kBox + row * 128 +
                        ((((col % 64) / 8) ^ (row % 8)) * 16);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x 64 fp32 accumulator as four 64 x 16 bf16 A operands: k-slice
// kk is columns [16 kk, 16 kk + 16), whose accumulator registers are
// 8 kk .. 8 kk + 7 in the A fragment's order.
__device__ __forceinline__ void to_a_operand(const float (&s)[32],
                                             uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      a[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
}

// d (64 x 64, fp32) = a * b (+ d if accumulate): a 64 x 16 and b 16 x 64
// from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, fp32) = a * b (+ d if accumulate): a 64 x 16 bf16 from
// registers (four 32-bit fragments), b 16 x 64 from shared memory,
// MN-major if TransB, else K-major.
template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(TransB));
}

// The same with b 16 x 128.
template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(TransB));
}

// Register i of a 64 x N accumulator lies in row r0 + 8 * acc_row(i) and
// column 8 * (i / 4) + c0 + (i % 2), where r0 = 16 * warp + lane / 4 and
// c0 = 2 * (lane % 4).
__device__ __forceinline__ constexpr int acc_row(int i) { return (i / 2) % 2; }
__device__ __forceinline__ constexpr int acc_col(int i) {
  return 8 * (i / 4) + i % 2;
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// ---------------------------------------------------------------------
// K3: O = softmax(scale * Q K^T) V, and lse per query row.
// ---------------------------------------------------------------------
template <int D>
constexpr int fwd_smem() {
  return (1 + 2 * kStages) * kTile * D * 2 + 8 * (1 + 2 * kStages) + 1024;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
             float* __restrict__ lse, Strides so, int T_q, int T_k, int H,
             int causal, float scale) {
  constexpr int kTileBytes = kTile * D * 2;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t sq = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t sk = sq + kTileBytes;            // kStages K tiles
  const uint32_t sv = sk + kStages * kTileBytes;  // kStages V tiles
  const uint32_t q_bar = sv + kStages * kTileBytes;
  const uint32_t full = q_bar + 8;                // + 8 s: stage s loaded
  const uint32_t empty = full + 8 * kStages;      // + 8 s: stage s free

  // the q tiles of one (b, h) run side by side, so its K and V are read
  // from device memory once and then from L2; longest first
  const int n_q = T_q / kTile;
  const int bh = blockIdx.x / n_q;
  const int qt = causal ? n_q - 1 - blockIdx.x % n_q : blockIdx.x % n_q;
  const int h = bh % H;
  const int b = bh / H;
  const int q0 = qt * kTile;
  // causal (T_q == T_k): kv tiles 0..qt, tile qt the only masked one
  const int n_kv = causal ? qt + 1 : T_k / kTile;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_bar, kTileBytes);
      tma_tile<D>(sq, &tm_q, q_bar, b, h, q0);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty + 8 * s, ((j / kStages) - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * kTileBytes);
        tma_tile<D>(sk + s * kTileBytes, &tm_k, full + 8 * s, b, h,
                    j * kTile);
        tma_tile<D>(sv + s * kTileBytes, &tm_v, full + 8 * s, b, h,
                    j * kTile);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * warp + lane / 4;  // rows r0 and r0 + 8
  const int c0 = 2 * (lane % 4);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-1e30f, -1e30f};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  // Q stays in registers as the A operand of every S = Q K^T
  mbar_wait(q_bar, 0);
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) load_a(sq, ks, qa[ks]);
  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kStages;
    const uint32_t ks_tile = sk + s * kTileBytes;
    const uint32_t vs_tile = sv + s * kTileBytes;
    mbar_wait(full + 8 * s, (j / kStages) & 1);

    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_rs<0>(sc, qa[ks], kmajor(ks_tile, ks), ks > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);

    const bool diag = causal && j == qt;
    float mx[2] = {-1e30f, -1e30f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = sc[i] * scale;
      if (diag && c0 + acc_col(i) > r0 + 8 * acc_row(i)) x = -1e30f;
      sc[i] = x;
      mx[acc_row(i)] = fmaxf(mx[acc_row(i)], x);
    }
    float alpha[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
      const float m_new = fmaxf(m[u], mx[u]);
      alpha[u] = exp2f((m[u] - m_new) * kLog2e);
      m[u] = m_new;
      l[u] *= alpha[u];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f((sc[i] - m[acc_row(i)]) * kLog2e);
      l[acc_row(i)] += p;
      sc[i] = p;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[acc_row(i)];
    uint32_t pa[4][4];
    to_a_operand(sc, pa);

    wg_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(acc, pa[kk], mnmajor(vs_tile, kk), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty + 8 * s);
  }

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
    const float ls = fmaxf(l[u], 1e-30f);
    const int row = q0 + r0 + 8 * u;
    bf16* orow = o + b * so.b + static_cast<long long>(row) * so.t + h * so.h;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + c0) =
          __floats2bfloat162_rn(acc[4 * n + 2 * u] / ls,
                                acc[4 * n + 2 * u + 1] / ls);
    if (lane % 4 == 0)
      lse[(static_cast<long long>(b) * H + h) * T_q + row] = m[u] + logf(ls);
  }
}

// ---------------------------------------------------------------------
// K4: dQ = scale * sum_kv dS K, dS = P o (dP - delta), P = exp(scale S -
// lse), dP = dO V^T. The q tile's rows are the rows of every product, as
// in K3, so P and dS stay on the accumulator fragments.
// ---------------------------------------------------------------------
template <int D>
constexpr int dq_smem() {
  return (2 + 2 * kStages) * kTile * D * 2 + 8 * (1 + 2 * kStages) + 1024;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dq_sm90(const __grid_constant__ CUtensorMap tm_q,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v,
            const __grid_constant__ CUtensorMap tm_do,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dq, Strides sdq, int T_q, int T_k, int H,
            int causal, float scale) {
  constexpr int kTileBytes = kTile * D * 2;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t sq = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t sdo = sq + kTileBytes;
  const uint32_t sk = sdo + kTileBytes;           // kStages K tiles
  const uint32_t sv = sk + kStages * kTileBytes;  // kStages V tiles
  const uint32_t q_bar = sv + kStages * kTileBytes;  // Q and dO loaded
  const uint32_t full = q_bar + 8;                // + 8 s: stage s loaded
  const uint32_t empty = full + 8 * kStages;      // + 8 s: stage s free

  // grid order as in K3: the q tiles of one (b, h) side by side, longest
  // first under causal
  const int n_q = T_q / kTile;
  const int bh = blockIdx.x / n_q;
  const int qt = causal ? n_q - 1 - blockIdx.x % n_q : blockIdx.x % n_q;
  const int h = bh % H;
  const int b = bh / H;
  const int q0 = qt * kTile;
  const int n_kv = causal ? qt + 1 : T_k / kTile;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_bar, 2 * kTileBytes);
      tma_tile<D>(sq, &tm_q, q_bar, b, h, q0);
      tma_tile<D>(sdo, &tm_do, q_bar, b, h, q0);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty + 8 * s, ((j / kStages) - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * kTileBytes);
        tma_tile<D>(sk + s * kTileBytes, &tm_k, full + 8 * s, b, h,
                    j * kTile);
        tma_tile<D>(sv + s * kTileBytes, &tm_v, full + 8 * s, b, h,
                    j * kTile);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * warp + lane / 4;  // rows r0 and r0 + 8
  const int c0 = 2 * (lane % 4);

  // this thread's two rows' lse and delta
  const long long vec = (static_cast<long long>(b) * H + h) * T_q + q0 + r0;
  const float ls[2] = {lse[vec], lse[vec + 8]};
  const float dl[2] = {delta[vec], delta[vec + 8]};

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  // Q and dO stay in registers as the A operands of every S and dP
  mbar_wait(q_bar, 0);
  uint32_t qa[D / 16][4], ga[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    load_a(sq, ks, qa[ks]);
    load_a(sdo, ks, ga[ks]);
  }
  float sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kStages;
    const uint32_t ks_tile = sk + s * kTileBytes;
    const uint32_t vs_tile = sv + s * kTileBytes;
    mbar_wait(full + 8 * s, (j / kStages) & 1);

    // S and dP in one group: no accumulator is touched while a wgmma
    // that owns one is in flight
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_rs<0>(sc, qa[ks], kmajor(ks_tile, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_rs<0>(dp, ga[ks], kmajor(vs_tile, ks), ks > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    const bool diag = causal && j == qt;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = sc[i] * scale;
      if (diag && c0 + acc_col(i) > r0 + 8 * acc_row(i)) x = -1e30f;
      const float p = exp2f((x - ls[acc_row(i)]) * kLog2e);
      dp[i] = p * (dp[i] - dl[acc_row(i)]);
    }
    uint32_t da[4][4];
    to_a_operand(dp, da);

    wg_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(acc, da[kk], mnmajor(ks_tile, kk), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty + 8 * s);
  }

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const long long row = q0 + r0 + 8 * u;
    bf16* drow = dq + b * sdq.b + row * sdq.t + h * sdq.h;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(drow + 8 * n + c0) =
          __floats2bfloat162_rn(acc[4 * n + 2 * u] * scale,
                                acc[4 * n + 2 * u + 1] * scale);
  }
}

// ---------------------------------------------------------------------
// delta[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d] in fp32: D / 8
// threads per row, 16 bytes each.
// ---------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(256) delta_kernel(
    const bf16* __restrict__ o, const bf16* __restrict__ dout,
    float* __restrict__ delta, Strides so, Strides sdo, int T, int H,
    long long rows) {
  constexpr int kLanes = D / 8;
  const long long gid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = gid / kLanes;  // (b, t, h) in row-major order
  const int part = static_cast<int>(gid % kLanes);
  const int h = static_cast<int>(row % H);
  const long long bt = row / H;
  const int t = static_cast<int>(bt % T);
  const long long b = bt / T;
  float acc = 0.f;
  if (row < rows) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        o + b * so.b + t * so.t + h * so.h + 8 * part);
    const uint4 gv = *reinterpret_cast<const uint4*>(
        dout + b * sdo.b + t * sdo.t + h * sdo.h + 8 * part);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(op[i]);
      const float2 g = __bfloat1622float2(gp[i]);
      acc = fmaf(a.x, g.x, acc);
      acc = fmaf(a.y, g.y, acc);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && part == 0) delta[(b * H + h) * T + t] = acc;
}

// ---------------------------------------------------------------------
// K5: dV = sum_q P^T dO, dK = scale * sum_q dS^T Q, P = exp(scale S -
// lse), dS = P o (dP - delta). Scores are formed transposed (kv rows,
// q columns), so they are the A operands of both updates as they lie.
// ---------------------------------------------------------------------
constexpr int kVec = kTile * 4;  // bytes of one q tile's lse (or delta)

template <int D>
constexpr int dkv_smem() {
  return (2 + 2 * kStages) * kTile * D * 2 + 2 * kStages * kVec +
         8 * (1 + 2 * kStages) + 1024;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_sm90(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const __grid_constant__ CUtensorMap tm_do,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sdk,
             Strides sdv, int T_q, int H, int BH, int causal, float scale) {
  constexpr int kTileBytes = kTile * D * 2;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t sk = (raw + 1023) & ~1023u;
  const uint32_t sv = sk + kTileBytes;
  const uint32_t sq = sv + kTileBytes;             // kStages Q tiles
  const uint32_t sdo = sq + kStages * kTileBytes;  // kStages dO tiles
  const uint32_t svec = sdo + kStages * kTileBytes;  // per stage: lse, delta
  const uint32_t kv_bar = svec + 2 * kStages * kVec;
  const uint32_t full = kv_bar + 8;
  const uint32_t empty = full + 8 * kStages;
  const float* vec = reinterpret_cast<const float*>(smem + (svec - raw));

  // the kv tiles of one (b, h) run side by side (Q and dO then come from
  // L2); under causal kv tile 0 is the longest
  const int n_k = gridDim.x / BH;
  const int bh = blockIdx.x / n_k;
  const int kt = blockIdx.x % n_k;
  const int h = bh % H;
  const int b = bh / H;
  const int k0 = kt * kTile;
  // causal: only q tiles at or after this kv tile see its keys
  const int q_first = causal ? kt : 0;
  const int n_it = T_q / kTile - q_first;
  const long long vec_row = (static_cast<long long>(b) * H + h) * T_q;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(kv_bar, 2 * kTileBytes);
      tma_tile<D>(sk, &tm_k, kv_bar, b, h, k0);
      tma_tile<D>(sv, &tm_v, kv_bar, b, h, k0);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        const int q0 = (q_first + it) * kTile;
        if (it >= kStages) mbar_wait(empty + 8 * s, ((it / kStages) - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * kTileBytes + 2 * kVec);
        tma_tile<D>(sq + s * kTileBytes, &tm_q, full + 8 * s, b, h, q0);
        tma_tile<D>(sdo + s * kTileBytes, &tm_do, full + 8 * s, b, h, q0);
        bulk_load(svec + 2 * s * kVec, lse + vec_row + q0, kVec,
                  full + 8 * s);
        bulk_load(svec + (2 * s + 1) * kVec, delta + vec_row + q0, kVec,
                  full + 8 * s);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * warp + lane / 4;  // keys k0 + r0 and k0 + r0 + 8
  const int c0 = 2 * (lane % 4);

  float gk[D / 2], gv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) gk[i] = gv[i] = 0.f;

  mbar_wait(kv_bar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    const uint32_t q_tile = sq + s * kTileBytes;
    const uint32_t do_tile = sdo + s * kTileBytes;
    const float* lse_s = vec + 2 * s * kTile;
    const float* delta_s = lse_s + kTile;
    const bool diag = causal && it == 0;
    mbar_wait(full + 8 * s, (it / kStages) & 1);

    // K and V stay A operands in shared memory: in registers beside the
    // four accumulators they would cost the second CTA per SM
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss(st, kmajor(sk, ks), kmajor(q_tile, ks), 1);
    wg_commit();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss(dpt, kmajor(sv, ks), kmajor(do_tile, ks), 1);
    wg_commit();

    // this thread's q columns: c0 + 8 n and c0 + 8 n + 1
    float2 lv[8], dl[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      lv[n] = *reinterpret_cast<const float2*>(lse_s + 8 * n + c0);
      dl[n] = *reinterpret_cast<const float2*>(delta_s + 8 * n + c0);
    }
    wg_wait<1>();
    fence_regs(st);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = st[i] * scale;
      if (diag && r0 + 8 * acc_row(i) > c0 + acc_col(i)) x = -1e30f;
      const float ls = (i % 2) ? lv[i / 4].y : lv[i / 4].x;
      st[i] = exp2f((x - ls) * kLog2e);
    }
    wg_wait<0>();
    fence_regs(dpt);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float d = (i % 2) ? dl[i / 4].y : dl[i / 4].x;
      dpt[i] = st[i] * (dpt[i] - d);
    }
    uint32_t pa[4][4], da[4][4];
    to_a_operand(st, pa);
    to_a_operand(dpt, da);

    wg_fence();
    fence_regs(gv);
    fence_regs(gk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(gv, pa[kk], mnmajor(do_tile, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(gk, da[kk], mnmajor(q_tile, kk), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(gv);
    fence_regs(gk);
    mbar_arrive(empty + 8 * s);
  }

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const long long row = k0 + r0 + 8 * u;
    bf16* krow = dk + b * sdk.b + row * sdk.t + h * sdk.h;
    bf16* vrow = dv + b * sdv.b + row * sdv.t + h * sdv.h;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(krow + 8 * n + c0) =
          __floats2bfloat162_rn(gk[4 * n + 2 * u] * scale,
                                gk[4 * n + 2 * u + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * n + c0) =
          __floats2bfloat162_rn(gv[4 * n + 2 * u], gv[4 * n + 2 * u + 1]);
    }
  }
}

// ---------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once; null if missing.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The 4-D (D, H, T, B) tensor map of a bf16 [B, T, H, D] tensor with
// element strides s = (batch, row, head) and a contiguous last
// dimension, read in 64 x 64 boxes (64 columns of D, 64 rows of T) with
// the 128-byte swizzle.
cudaError_t tensor_map(CUtensorMap* map, const void* base,
                       const long long* s, int B, int T, int H, int D) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s[2]) * 2,
                                 static_cast<cuuint64_t>(s[1]) * 2,
                                 static_cast<cuuint64_t>(s[0]) * 2};
  const cuuint32_t box[4] = {64, 1, kTile, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, const long long* s, int B, int T_q,
                       int T_k, int H, int causal, float scale,
                       cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err = tensor_map(&mq, q, s, B, T_q, H, D);
  if (err == cudaSuccess) err = tensor_map(&mk, k, s + 3, B, T_k, H, D);
  if (err == cudaSuccess) err = tensor_map(&mv, v, s + 6, B, T_k, H, D);
  if (err == cudaSuccess) err = allow_smem(fwd_sm90<D>, fwd_smem<D>());
  if (err != cudaSuccess) return err;
  fwd_sm90<D><<<(T_q / kTile) * B * H, kThreads, fwd_smem<D>(), stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), lse, strides_at(s, 3), T_q, T_k, H,
      causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_delta(const void* o, const void* dout, float* delta,
                         const long long* s, int B, int T, int H,
                         cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * T * H;
  const long long blocks = (rows * (D / 8) + 255) / 256;
  if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  delta_kernel<D><<<static_cast<int>(blocks), 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta,
      strides_at(s, 0), strides_at(s, 1), T, H, rows);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, const long long* s, int B, int T_q, int T_k,
                      int H, int causal, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err = tensor_map(&mq, q, s, B, T_q, H, D);
  if (err == cudaSuccess) err = tensor_map(&mk, k, s + 3, B, T_k, H, D);
  if (err == cudaSuccess) err = tensor_map(&mv, v, s + 6, B, T_k, H, D);
  if (err == cudaSuccess) err = tensor_map(&mdo, dout, s + 9, B, T_q, H, D);
  if (err == cudaSuccess) err = allow_smem(dq_sm90<D>, dq_smem<D>());
  if (err != cudaSuccess) return err;
  dq_sm90<D><<<(T_q / kTile) * B * H, kThreads, dq_smem<D>(), stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<bf16*>(dq), strides_at(s, 4),
      T_q, T_k, H, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv,
                       const long long* s, int B, int T_q, int T_k, int H,
                       int causal, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err = tensor_map(&mq, q, s, B, T_q, H, D);
  if (err == cudaSuccess) err = tensor_map(&mk, k, s + 3, B, T_k, H, D);
  if (err == cudaSuccess) err = tensor_map(&mv, v, s + 6, B, T_k, H, D);
  if (err == cudaSuccess) err = tensor_map(&mdo, dout, s + 9, B, T_q, H, D);
  if (err == cudaSuccess) err = allow_smem(dkv_sm90<D>, dkv_smem<D>());
  if (err != cudaSuccess) return err;
  dkv_sm90<D><<<(T_k / kTile) * B * H, kThreads, dkv_smem<D>(), stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), strides_at(s, 4), strides_at(s, 5), T_q, H,
      B * H, causal, scale);
  return cudaGetLastError();
}

bool shape_ok(int B, int T_q, int T_k, int H, int D, int causal) {
  return B > 0 && H > 0 && T_q > 0 && T_k > 0 && T_q % kTile == 0 &&
         T_k % kTile == 0 && (!causal || T_q == T_k) && (D == 64 || D == 128) &&
         static_cast<long long>(T_q > T_k ? T_q : T_k) / kTile * B * H <
             (1ll << 31);
}

}  // namespace

// bf16 only; D 64 or 128. Pointers are device pointers; `strides` is a
// host array of (batch, row, head) element strides, three per tensor in
// argument order (forward: q, k, v, o; delta: o, dout; dQ: q, k, v,
// dout, dq; dK/dV: q, k, v, dout, dk, dv); the last dimension of every
// tensor is contiguous, and q, k, v, o and dout have 16-byte aligned
// bases and strides (the Python wrapper checks). lse and delta are
// contiguous [B, H, T_q] fp32: the forward writes lse, the delta pass
// writes delta, and the dQ and dK/dV launches of one backward read the
// same two. Causal needs T_q == T_k. Returns a cudaError_t.
extern "C" int flash_fwd_sm90_launch(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     const long long* strides, int B,
                                     int T_q, int T_k, int H, int D,
                                     int causal, float scale, void* stream) {
  if (!shape_ok(B, T_q, T_k, H, D, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return static_cast<int>(
      D == 64 ? launch_fwd<64>(q, k, v, o, l, strides, B, T_q, T_k, H,
                               causal, scale, st)
              : launch_fwd<128>(q, k, v, o, l, strides, B, T_q, T_k, H,
                                causal, scale, st));
}

extern "C" int flash_bwd_delta_sm90_launch(const void* o, const void* dout,
                                           void* delta,
                                           const long long* strides, int B,
                                           int T, int H, int D,
                                           void* stream) {
  if (!shape_ok(B, T, T, H, D, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dl = static_cast<float*>(delta);
  return static_cast<int>(
      D == 64 ? launch_delta<64>(o, dout, dl, strides, B, T, H, st)
              : launch_delta<128>(o, dout, dl, strides, B, T, H, st));
}

extern "C" int flash_bwd_dq_sm90_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const long long* strides,
    int B, int T_q, int T_k, int H, int D, int causal, float scale,
    void* stream) {
  if (!shape_ok(B, T_q, T_k, H, D, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  return static_cast<int>(
      D == 64 ? launch_dq<64>(q, k, v, dout, l, dl, dq, strides, B, T_q, T_k,
                              H, causal, scale, st)
              : launch_dq<128>(q, k, v, dout, l, dl, dq, strides, B, T_q,
                               T_k, H, causal, scale, st));
}

extern "C" int flash_bwd_dkv_sm90_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const long long* strides, int B, int T_q, int T_k, int H, int D,
    int causal, float scale, void* stream) {
  if (!shape_ok(B, T_q, T_k, H, D, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  return static_cast<int>(
      D == 64 ? launch_dkv<64>(q, k, v, dout, l, dl, dk, dv, strides, B, T_q,
                               T_k, H, causal, scale, st)
              : launch_dkv<128>(q, k, v, dout, l, dl, dk, dv, strides, B,
                                T_q, T_k, H, causal, scale, st));
}

extern "C" const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
