// Single-token decode attention over the paged KV pool for Hopper: the
// cluster split walk of paged_walk.cuh over pages, launched by
// paged_attention.cu (B5) and paged_attention_quant.cu (B6), one library
// each, each instantiating its own formats.
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
// to [0, N-1], as the TPU kernel clips its scalar-prefetched table) at slot
// pos % bs.  Pages wholly outside [start, length) are never read, so unused
// table entries are harmless.  The pool's layer slice pages[:, li] of the
// (N,L,Hkv,bs,.) pool is read through its page and head strides, never
// copied; its slots must be contiguous rows (slot stride = row length, and 1
// for the scale planes), as in every pool the engine builds.
//
// What bounds them on the H100: the bytes of the live pages over 3.35 TB/s.
// The TPU kernel walks a sequence's pages one grid step after another with
// the page DMA'd ahead; on this card one (b, hk) walked by one block is a
// chain of dependent round trips.  So the walk splits each (b, hk) over the
// 8 blocks of a thread-block cluster, each taking whole pages, reads the
// table once, stages the pages' rows of [start, length) in shared memory
// with cp.async several pages ahead, and merges the blocks' softmax states
// through distributed shared memory in the same launch (paged_walk.cuh).
#pragma once

#include "paged_walk.cuh"

using namespace paged_walk;

extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// q (B,Hkv,G,D) f32 contiguous; k/v the pages, unit stride along the last
// dim, contiguous slots, 16-byte aligned rows; k_scale/v_scale (N,Hkv,bs) f32
// with contiguous slots, or null (format 0 and 1); block_tables (B,P) int32
// contiguous; lengths (B,) int32; starts (B,) int32 or null; strides: 12
// values in elements, (page, head, slot) of k, v, k_scale, v_scale; out
// (B,Hkv,G,D), l and m (B,Hkv,G) f32.  format: 0 bf16, 1 f32, 2 int8, 3 int4.
template <bool kScaled>
static int paged_launch(const void* q, const void* k, const void* k_scale, const void* v,
                        const void* v_scale, const void* block_tables, const void* lengths,
                        const void* starts, void* out, void* l, void* m, int B, int Hkv,
                        int G, int N, int bs, int P, int D, int format,
                        const long long* strides, float sm_scale, void* stream) {
  Params p{};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const unsigned char*>(k);
  p.v = static_cast<const unsigned char*>(v);
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.tables = static_cast<const int*>(block_tables);
  p.lengths = static_cast<const int*>(lengths);
  p.starts = static_cast<const int*>(starts);
  p.out = static_cast<float*>(out);
  p.l = static_cast<float*>(l);
  p.m = static_cast<float*>(m);
  p.Hkv = Hkv;
  p.G = G;
  p.N = N;
  p.P = P;
  p.bs = bs;
  p.cap = P * bs;
  p.sm_scale = sm_scale;
  return run<Src::Paged, kScaled>(format, D, p, strides, B, static_cast<cudaStream_t>(stream));
}
