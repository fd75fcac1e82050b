// K1: paged-KV decode attention over pages in q's type (fp32 or
// bf16), for Hopper (sm_90a). Replaces the TPU kernel
// ray_tpu/ops/paged_attention.py::_kernel (body _attend_page), launched
// by paged_decode_attention there. bf16 takes the tensor-core split
// pass split_sm90 (paged_decode_attention_sm90.cuh); fp32 the scalar
// split_kernel (paged_decode_attention.cuh), whose bound and design are
// described there. Either ends in the same merge_tail: one launch per
// call.
//
// Plain C interface, bound with ctypes by ray_tpu_torch/ops/_build.py
// and ray_tpu_torch/ops/paged_attention.py. The launch returns
// cudaGetLastError().

#include "paged_decode_attention.cuh"
#include "paged_decode_attention_sm90.cuh"

// K1. dtype: 0 = float32, 1 = bfloat16, for q, the pages and out.
// Pointers are device pointers of contiguous tensors: q and out
// [B, H, D], pages [KH, n_pages, Pg, D], page_table [B, max_pages]
// int32, positions [B] int32, fp32 scratch part_acc
// [B, KH, n_splits, H/KH, D], part_m and part_l [B, KH, n_splits, H/KH]
// with n_splits = ceil(max_pages * Pg / split), and int32 counters
// [B * KH], zero before the launch and zero again after it (no other
// launch may use them meanwhile); bf16 takes split 64, 128 or 256.
// Returns a cudaError_t; cudaErrorInvalidValue for shapes the kernel
// does not take (the Python wrapper checks them first).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* pages_k, const void* pages_v,
    const void* page_table, const void* positions, void* out,
    void* part_acc, void* part_m, void* part_l, void* counters, int B,
    int H, int KH, int D, int n_pages, int Pg, int max_pages, int split,
    int dtype, void* stream) {
  if (bad_shape(B, H, KH, n_pages, Pg, max_pages, split))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RTT_LAUNCH(T, DD)                                                    \
  return launch<T, T, DD>(q, pages_k, pages_v, nullptr, nullptr,            \
                          page_table, positions, out, part_acc, part_m,      \
                          part_l, counters, B, H, KH, n_pages, Pg,           \
                          max_pages, split, s)
  if (dtype == 0 && D == 64) RTT_LAUNCH(float, 64);
  if (dtype == 0 && D == 128) RTT_LAUNCH(float, 128);
#undef RTT_LAUNCH
#define RTT_LAUNCH_SM90(DD)                                                 \
  return launch_split_sm90<bf16, DD>(q, pages_k, pages_v, nullptr, nullptr, \
                                     page_table, positions, out, part_acc, \
                                     part_m, part_l, counters, B, H, KH,   \
                                     n_pages, Pg, max_pages, split, s)
  if (dtype == 1 && D == 64) RTT_LAUNCH_SM90(64);
  if (dtype == 1 && D == 128) RTT_LAUNCH_SM90(128);
#undef RTT_LAUNCH_SM90
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* paged_decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
