// B5: single-token decode attention over the bf16 or f32 paged KV pool,
// the walk of paged_launch.cuh.  Replaces
// src/repro/kernels/paged_attention/kernel.py ::
// paged_decode_attention_pallas (_paged_decode_kernel).
#include "paged_launch.cuh"

// B5: format 0 (bf16) or 1 (f32), no scales.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* block_tables,
    const void* lengths, const void* starts, void* out, void* l, void* m, int B, int Hkv,
    int G, int N, int bs, int P, int D, int kv_bf16, const long long* strides,
    float sm_scale, void* stream) {
  return paged_launch<false>(q, k, nullptr, v, nullptr, block_tables, lengths, starts, out, l,
                             m, B, Hkv, G, N, bs, P, D, kv_bf16 ? 0 : 1, strides, sm_scale,
                             stream);
}
