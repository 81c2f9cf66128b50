// Single-token decode attention over one layer of a shared page pool
// (L, NP, KV, P, hd), read through a (B, MP) int32 page table: logical slot
// s of row b lives at pool page table[b, s / P], in-page offset s % P.
// Unallocated table entries point at the trash page 0, whose slots kv_valid
// masks. The bf16/f32 pool, and the int8 pool with f32 (L, NP, KV, P)
// scales. f32 inside.
//
// Replaces: mosstts_tpu/ops/pallas/paged_attn.py::paged_decode_attention
// (_paged_kernel) and ::paged_decode_attention_q8 (_paged_kernel_q8).
//
// Bound on the H100: the pool bytes of the attended pages, as for the linear
// cache (decode_attn.cu); the page table adds 4 bytes per P slots. Design:
// the split-KV kernel of decode_kernel.cuh over logical slots; the kernel
// reads the table from device memory and addresses each slot's page itself,
// so no gather into a linear buffer and no host copy of the table.
#include "decode_kernel.cuh"

// C entry points, bound with ctypes (ops/kernels/paged_attn.py); arguments
// as for decode_attn.cu's, with args->table and args->page_size set and the
// value strides c_sb / s_sb stepping over pool pages.
extern "C" int mosstts_paged_decode_attention(const mosstts::decode::Args* args, int B, int hd,
                                              int q_dtype, void* stream) {
    return mosstts::decode::dispatch<false, true>(args, B, hd, q_dtype, stream);
}

extern "C" int mosstts_paged_decode_attention_q8(const mosstts::decode::Args* args, int B,
                                                 int hd, int q_dtype, void* stream) {
    return mosstts::decode::dispatch<true, true>(args, B, hd, q_dtype, stream);
}
