// Single-token decode attention over the contiguous KV cache (the decode
// engine) for Hopper: the cluster split walk of paged_walk.cuh over a slot.
//
// B3 replaces src/repro/kernels/decode_attention/kernel.py ::
// decode_attention_pallas (_decode_kernel): k/v (B,Hkv,S,D) bf16 or f32.
//
// B4 replaces the same file's decode_attention_quant_pallas
// (_decode_quant_kernel, _dequant_tile): k/v are the packed payload
// (B,Hkv,S,Dp), int8 (Dp = D) or int4 nibble pairs (Dp = D/2), with f32
// scale planes (B,Hkv,S), dequantized in registers on the way to the dot.
//
// Query row b reads slot b / rows_per_slot: 1 for decode, the W = k + 1
// rows of a speculative verify block (each with its own length) otherwise,
// so a verify round walks all B * W rows in one launch a layer.
//
// The cache is read through its (batch, head) strides: the per-layer slice
// cache[:, li] of the batch-leading (B,L,Hkv,S,.) cache is used where it
// lies, never copied.  A slot's rows must be contiguous (position stride =
// row length, and 1 for the scale planes), as in every cache the engine
// builds; other strides are refused.
//
// What bounds them on the H100: the cache bytes of the live positions,
// 2 * sum_b (length_b - start_b) * Hkv * (Dp * sizeof(T) + 4 if scaled),
// over 3.35 TB/s.  The TPU kernel walks a sequence's positions one grid
// step after another; on this card one (b, hk) walked by one block is a
// chain of dependent round trips on one SM.  So each (b, hk) is split over
// the 8 blocks of a thread-block cluster, each taking whole 16-row virtual
// pages of the slot; a chunk of pages is one contiguous run of rows, which
// one thread fetches into shared memory with two bulk copies; the blocks'
// softmax states merge through distributed shared memory in the same
// launch.  It is the walk of B5/B6 without the table, and gives the same
// bits as B5/B6 over 16-row pages holding the same rows.
#include "paged_walk.cuh"

using namespace paged_walk;

extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

static int slot_launch(const void* q, const void* k, const void* k_scale, const void* v,
                       const void* v_scale, const void* lengths, const void* starts, void* out,
                       void* l, void* m, int B, int Hkv, int G, int S, int D, int format,
                       const long long* strides, int rows_per_slot, float sm_scale,
                       void* stream) {
  if (rows_per_slot < 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const unsigned char*>(k);
  p.v = static_cast<const unsigned char*>(v);
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.lengths = static_cast<const int*>(lengths);
  p.starts = static_cast<const int*>(starts);
  p.out = static_cast<float*>(out);
  p.l = static_cast<float*>(l);
  p.m = static_cast<float*>(m);
  p.Hkv = Hkv;
  p.G = G;
  p.bs = kSlotPage;
  p.cap = S;
  p.rows_per_slot = rows_per_slot;
  p.sm_scale = sm_scale;
  return run<Src::Slot>(format, D, p, strides, B, static_cast<cudaStream_t>(stream));
}

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
  return slot_launch(q, k, nullptr, v, nullptr, lengths, starts, out, l, m, B, Hkv, G, S, D,
                     kv_bf16 ? 0 : 1, strides, rows_per_slot, sm_scale, stream);
}

// B4.  k/v the packed payload (B/R,Hkv,S,Dp): int8 (int4 == 0) or uint8
// nibble pairs (int4 != 0), unit stride along Dp, 16-byte aligned rows;
// k_scale/v_scale (B/R,Hkv,S) f32.  strides: 12 values in elements, (batch,
// head, position) of k, v, k_scale, v_scale.  The rest as B3.
extern "C" int decode_attention_quant_launch(
    const void* q, const void* k, const void* k_scale, const void* v, const void* v_scale,
    const void* lengths, const void* starts, void* out, void* l, void* m, int B, int Hkv,
    int G, int S, int D, int int4, const long long* strides, int rows_per_slot, float sm_scale,
    void* stream) {
  return slot_launch(q, k, k_scale, v, v_scale, lengths, starts, out, l, m, B, Hkv, G, S, D,
                     int4 ? 3 : 2, strides, rows_per_slot, sm_scale, stream);
}
