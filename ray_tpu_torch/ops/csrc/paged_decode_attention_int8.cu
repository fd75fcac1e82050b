// K2: paged-KV decode attention over int8 pages, each (kv head, page)
// with one fp32 absmax scale s ([KH, n_pages, 1]; a stored q8 means
// q8 * s / 127), for Hopper (sm_90a). Replaces the TPU kernel
// ray_tpu/ops/paged_attention.py::_kernel_q, launched by
// paged_decode_attention there with scales.
//
// Bound: device memory, half of K1's payload bytes:
// 2 * sum_b(pos_b + 1) * KH * D bytes of int8 keys and values, plus
// 2 * 4 * KH bytes of scales per visible page, plus q and out: 9.5 MB
// at the TinyLlama-1.1B decode shape, 2.8 us at 3.35 TB/s. What the
// design does about it: the int8 bytes are what moves — staged as they
// are in shared memory, 16 values per 16-byte copy, with each page's
// scale read through the page id the block already holds; no
// conversion kernel runs before the launch and no fp copy of the pool
// or of the window is written.
//   - bf16 q (the served dtype) runs the tensor-core split pass
//     split_sm90<int8_t, D, KW> (paged_decode_attention_sm90.cuh):
//     cp.async stages the whole split, each lane widens the int8 bytes
//     it copied to bf16 exactly, mma.sync takes the products, and the
//     scales are folded into S and P in fp32.
//   - fp32 q keeps the scalar split_kernel<float, int8_t, D>
//     (paged_decode_attention.cuh), which dequantizes in registers; its
//     serial phases, not bytes, set its pace.
// Either ends in merge_tail: one launch per call.
//
// Plain C interface, bound with ctypes by ray_tpu_torch/ops/_build.py
// and ray_tpu_torch/ops/paged_attention.py. The launch returns
// cudaGetLastError().

#include "paged_decode_attention.cuh"
#include "paged_decode_attention_sm90.cuh"

// As K1, with int8 pages and their fp32 scales scales_k/scales_v
// [KH, n_pages, 1]; dtype (0 = float32, 1 = bfloat16) is q's and out's;
// bf16 takes split 64, 128 or 256.
extern "C" int paged_decode_attention_int8_launch(
    const void* q, const void* pages_k, const void* pages_v,
    const void* scales_k, const void* scales_v, const void* page_table,
    const void* positions, void* out, void* part_acc, void* part_m,
    void* part_l, void* counters, int B, int H, int KH, int D,
    int n_pages, int Pg, int max_pages, int split, int dtype,
    void* stream) {
  if (bad_shape(B, H, KH, n_pages, Pg, max_pages, split))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RTT_LAUNCH(T, DD)                                                    \
  return launch<T, int8_t, DD>(q, pages_k, pages_v, scales_k, scales_v,     \
                               page_table, positions, out, part_acc, part_m, \
                               part_l, counters, B, H, KH, n_pages, Pg,      \
                               max_pages, split, s)
  if (dtype == 0 && D == 64) RTT_LAUNCH(float, 64);
  if (dtype == 0 && D == 128) RTT_LAUNCH(float, 128);
#undef RTT_LAUNCH
#define RTT_LAUNCH_SM90(DD)                                                 \
  return launch_split_sm90<int8_t, DD>(                                     \
      q, pages_k, pages_v, scales_k, scales_v, page_table, positions, out, \
      part_acc, part_m, part_l, counters, B, H, KH, n_pages, Pg,           \
      max_pages, split, s)
  if (dtype == 1 && D == 64) RTT_LAUNCH_SM90(64);
  if (dtype == 1 && D == 128) RTT_LAUNCH_SM90(128);
#undef RTT_LAUNCH_SM90
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* paged_decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
