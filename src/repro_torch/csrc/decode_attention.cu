// Single-token decode attention over the contiguous KV cache (the decode
// engine) for Hopper: the walk of decode_walk.cuh over a strided slot.
//
// B3 replaces src/repro/kernels/decode_attention/kernel.py ::
// decode_attention_pallas (_decode_kernel): k/v (B,Hkv,S,D) bf16 or f32.
//
// B4 replaces the same file's decode_attention_quant_pallas
// (_decode_quant_kernel, _dequant_tile): k/v are the packed payload
// (B,Hkv,S,Dp), int8 (Dp = D) or int4 nibble pairs (Dp = D/2), with f32
// scale planes (B,Hkv,S), dequantized in registers on the way to the dot.
//
// What bounds them on the H100: the cache bytes of the live positions,
// 2 * sum_b (length_b - start_b) * Hkv * (Dp * sizeof(T) + 4 if scaled),
// over 3.35 TB/s.  The cache is read through its (batch, head, position)
// strides: the per-layer slice cache[:, li] of the batch-leading
// (B,L,Hkv,S,·) cache is used where it lies, never copied.  A split over
// positions across blocks (for few sequences with long contexts) is later
// work.
#include "decode_walk.cuh"

using namespace decode_walk;

extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// B3.  q (B,Hkv,G,D) f32 contiguous; k/v (B,Hkv,S,D) bf16 (kv_bf16 != 0) or
// f32 with unit stride along D, 16-byte aligned rows and the given (batch,
// head, position) strides in elements; lengths (B,) int32; starts (B,) int32
// or null; out (B,Hkv,G,D), l and m (B,Hkv,G) f32 contiguous.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* lengths, const void* starts,
    void* out, void* l, void* m, int B, int Hkv, int G, int S, int D, int kv_bf16,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, float sm_scale, void* stream) {
  Strided src{{{ksb, ksh, kss}, {vsb, vsh, vss}, {0, 0, 0}, {0, 0, 0}}, S};
  const Args a{q, k, v, nullptr, nullptr, lengths, starts, out, l, m, B, Hkv, G, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return kv_bf16 ? dispatch<Bf16>(D, a, src) : dispatch<F32>(D, a, src);
}

// B4.  k/v the packed payload (B,Hkv,S,Dp): int8 (int4 == 0) or uint8
// nibble pairs (int4 != 0), unit stride along Dp, 16-byte aligned rows;
// k_scale/v_scale (B,Hkv,S) f32.  strides: 12 values in elements, (batch,
// head, position) of k, v, k_scale, v_scale.  The rest as B3.
extern "C" int decode_attention_quant_launch(
    const void* q, const void* k, const void* k_scale, const void* v, const void* v_scale,
    const void* lengths, const void* starts, void* out, void* l, void* m, int B, int Hkv,
    int G, int S, int D, int int4, const long long* strides, float sm_scale, void* stream) {
  Strided src{};
  for (int i = 0; i < 12; ++i) src.st[i / 3][i % 3] = strides[i];
  src.S = S;
  const Args a{q, k, v, k_scale, v_scale, lengths, starts, out, l, m, B, Hkv, G, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return int4 ? dispatch<Int4>(D, a, src) : dispatch<Int8>(D, a, src);
}
