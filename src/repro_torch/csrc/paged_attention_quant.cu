// B6: single-token decode attention over the int8 or int4 paged KV pool
// and its f32 scale planes, the walk of paged_launch.cuh.  Replaces
// src/repro/kernels/paged_attention/kernel.py ::
// paged_decode_attention_quant_pallas (_paged_decode_quant_kernel).
#include "paged_launch.cuh"

// B6: int8 (int4 == 0) or int4 nibble pairs (int4 != 0), with scales.
extern "C" int paged_decode_attention_quant_launch(
    const void* q, const void* k, const void* k_scale, const void* v, const void* v_scale,
    const void* block_tables, const void* lengths, const void* starts, void* out, void* l,
    void* m, int B, int Hkv, int G, int N, int bs, int P, int D, int int4,
    const long long* strides, float sm_scale, void* stream) {
  return paged_launch<true>(q, k, k_scale, v, v_scale, block_tables, lengths, starts, out, l,
                            m, B, Hkv, G, N, bs, P, D, int4 ? 3 : 2, strides, sm_scale,
                            stream);
}
