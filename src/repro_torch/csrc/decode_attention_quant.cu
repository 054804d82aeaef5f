// B4: single-token decode attention over the int8 or int4 contiguous KV
// cache and its f32 scale planes, the walk of slot_launch.cuh.  Replaces
// src/repro/kernels/decode_attention/kernel.py ::
// decode_attention_quant_pallas (_decode_quant_kernel, _dequant_tile).
#include "slot_launch.cuh"

// B4.  k/v the packed payload (B/R,Hkv,S,Dp): int8 (int4 == 0) or uint8
// nibble pairs (int4 != 0), unit stride along Dp, 16-byte aligned rows;
// k_scale/v_scale (B/R,Hkv,S) f32.  strides: 12 values in elements, (batch,
// head, position) of k, v, k_scale, v_scale.  The rest as B3.
extern "C" int decode_attention_quant_launch(
    const void* q, const void* k, const void* k_scale, const void* v, const void* v_scale,
    const void* lengths, const void* starts, void* out, void* l, void* m, int B, int Hkv,
    int G, int S, int D, int int4, const long long* strides, int rows_per_slot, float sm_scale,
    void* stream) {
  return slot_launch<true>(q, k, k_scale, v, v_scale, lengths, starts, out, l, m, B, Hkv, G, S,
                           D, int4 ? 3 : 2, strides, rows_per_slot, sm_scale, stream);
}
