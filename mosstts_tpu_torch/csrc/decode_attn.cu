// Single-token decode attention over one layer of the layer-stacked linear KV
// cache (L, B, KV, S, hd): the bf16/f32 cache, and the int8 cache with f32
// (L, B, KV, S) K and V scales. f32 inside.
//
// Replaces: mosstts_tpu/ops/pallas/decode_attn.py::decode_attention
// (_decode_kernel) and ::decode_attention_q8 (_decode_kernel_q8).
//
// Bound on the H100: the cache bytes streamed, hd * attend_len K and V values
// per (row, KV head): 2 bytes each in bf16, 1 byte plus one 4-byte scale per
// 128 values in int8. Design: the split-KV kernel of decode_kernel.cuh,
// whose header says how the loads are issued and the scales folded.
#include "decode_kernel.cuh"

// Slots per block of the first pass: the wrappers size the f32 scratch as
// B * KV * ceil(attend_len / chunk) * G * (hd + 2).
extern "C" int mosstts_decode_chunk_slots() { return mosstts::decode::CHUNK; }

// C entry points, bound with ctypes (ops/kernels/decode_attn.py). ``args``
// holds pointers and strides (in elements; the head dim contiguous);
// q_dtype is 0 for bf16, 1 for f32. Each returns the cudaGetLastError()
// after its two launches.
extern "C" int mosstts_decode_attention(const mosstts::decode::Args* args, int B, int hd,
                                        int q_dtype, void* stream) {
    return mosstts::decode::dispatch<false, false>(args, B, hd, q_dtype, stream);
}

extern "C" int mosstts_decode_attention_q8(const mosstts::decode::Args* args, int B, int hd,
                                           int q_dtype, void* stream) {
    return mosstts::decode::dispatch<true, false>(args, B, hd, q_dtype, stream);
}
