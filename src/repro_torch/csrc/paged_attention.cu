// Single-token decode attention over the paged KV pool for Hopper: the walk
// of decode_walk.cuh with each position's row looked up in the block table.
//
// B5 replaces src/repro/kernels/paged_attention/kernel.py ::
// paged_decode_attention_pallas (_paged_decode_kernel): one layer's pages
// (N,Hkv,bs,D) bf16 or f32.
//
// B6 replaces the same file's paged_decode_attention_quant_pallas
// (_paged_decode_quant_kernel): packed pages (N,Hkv,bs,Dp), int8 or int4
// nibble pairs, with f32 scale planes (N,Hkv,bs), dequantized in registers.
//
// Sequence b's position pos lives at page block_tables[b, pos / bs] (clipped
// to [0, N-1], as the TPU kernel clips its scalar-prefetched table) at
// in-page offset pos % bs.  Pages wholly past a sequence's length are never
// read: the walk stops at the length, so unused table entries (0) are
// harmless.  What bounds them on the H100: the bytes of the live positions'
// rows (and scales) over 3.35 TB/s, as for B3/B4; the table reads are
// cached.  The pool's layer slice pages[:, li] of the (N,L,Hkv,bs,·) pool is
// read through its strides, never copied.  Prefetching whole pages with
// cp.async or TMA is later work.
#include "decode_walk.cuh"

using namespace decode_walk;

extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// q (B,Hkv,G,D) f32 contiguous; k/v the pages, unit stride along the last
// dim, 16-byte aligned rows; k_scale/v_scale (N,Hkv,bs) f32 or null
// (format 0 and 1); block_tables (B,P) int32 contiguous; lengths (B,) int32;
// starts (B,) int32 or null; strides: 12 values in elements, (page, head,
// slot) of k, v, k_scale, v_scale; out (B,Hkv,G,D), l and m (B,Hkv,G) f32.
// format: 0 bf16, 1 f32, 2 int8, 3 int4.
static int paged_launch(const void* q, const void* k, const void* k_scale, const void* v,
                        const void* v_scale, const void* block_tables, const void* lengths,
                        const void* starts, void* out, void* l, void* m, int B, int Hkv,
                        int G, int N, int bs, int P, int D, int format,
                        const long long* strides, float sm_scale, void* stream) {
  Paged src{};
  for (int i = 0; i < 12; ++i) src.st[i / 3][i % 3] = strides[i];
  src.tables = static_cast<const int*>(block_tables);
  src.P = P;
  src.N = N;
  src.bs = bs;
  const Args a{q, k, v, k_scale, v_scale, lengths, starts, out, l, m, B, Hkv, G, sm_scale,
               static_cast<cudaStream_t>(stream)};
  switch (format) {
    case 0: return dispatch<Bf16>(D, a, src);
    case 1: return dispatch<F32>(D, a, src);
    case 2: return dispatch<Int8>(D, a, src);
    case 3: return dispatch<Int4>(D, a, src);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// B5: format 0 (bf16) or 1 (f32), no scales.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* block_tables,
    const void* lengths, const void* starts, void* out, void* l, void* m, int B, int Hkv,
    int G, int N, int bs, int P, int D, int kv_bf16, const long long* strides,
    float sm_scale, void* stream) {
  return paged_launch(q, k, nullptr, v, nullptr, block_tables, lengths, starts, out, l, m,
                      B, Hkv, G, N, bs, P, D, kv_bf16 ? 0 : 1, strides, sm_scale, stream);
}

// B6: int8 (int4 == 0) or int4 nibble pairs (int4 != 0), with scales.
extern "C" int paged_decode_attention_quant_launch(
    const void* q, const void* k, const void* k_scale, const void* v, const void* v_scale,
    const void* block_tables, const void* lengths, const void* starts, void* out, void* l,
    void* m, int B, int Hkv, int G, int N, int bs, int P, int D, int int4,
    const long long* strides, float sm_scale, void* stream) {
  return paged_launch(q, k, k_scale, v, v_scale, block_tables, lengths, starts, out, l, m,
                      B, Hkv, G, N, bs, P, D, int4 ? 3 : 2, strides, sm_scale, stream);
}
