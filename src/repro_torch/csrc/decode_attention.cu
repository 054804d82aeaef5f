// B3: single-token decode attention over the contiguous bf16 or f32 KV
// cache, the walk of slot_launch.cuh.  Replaces
// src/repro/kernels/decode_attention/kernel.py :: decode_attention_pallas
// (_decode_kernel).
#include "slot_launch.cuh"

// B3.  q (B,Hkv,G,D) f32 contiguous, B query rows; k/v (B/R,Hkv,S,D) bf16
// (kv_bf16 != 0) or f32 with unit stride along D, 16-byte aligned rows and
// the given (batch, head, position) strides in elements, R = rows_per_slot;
// lengths (B,) int32; starts (B,) int32 or null; out (B,Hkv,G,D), l and m
// (B,Hkv,G) f32 contiguous.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* lengths, const void* starts,
    void* out, void* l, void* m, int B, int Hkv, int G, int S, int D, int kv_bf16,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, int rows_per_slot, float sm_scale, void* stream) {
  const long long strides[12] = {ksb, ksh, kss, vsb, vsh, vss, 0, 0, 0, 0, 0, 0};
  return slot_launch<false>(q, k, nullptr, v, nullptr, lengths, starts, out, l, m, B, Hkv, G,
                            S, D, kv_bf16 ? 0 : 1, strides, rows_per_slot, sm_scale, stream);
}
