// Single-token decode attention over one layer of the layer-stacked linear KV
// cache (L, B, KV, S, hd): the bf16/f32 cache, and the int8 cache with
// (L, B, KV, S) K and V scales, f32 (decode_attention_q8) or bf16 or f32
// (decode_attention_q8t). f32 inside.
//
// Replaces: mosstts_tpu/ops/pallas/decode_attn.py::decode_attention
// (_decode_kernel), ::decode_attention_q8 (_decode_kernel_q8) and
// ::decode_attention_q8t (_decode_kernel_q8t). The TPU q8t kernel reads its
// scales pre-tiled (pack_kv_scales / pack_valid) to get around a Mosaic
// lane-concat limit; here the scales keep the (L, B, KV, S) layout and only
// their type changes.
//
// Bound on the H100: the cache bytes streamed, hd * attend_len K and V values
// per (row, KV head): 2 bytes each in bf16, 1 byte plus one 4-byte (or, q8t
// with bf16 scales, 2-byte) scale per 128 values in int8. Design: the
// one-launch split-KV kernel of decode_kernel.cuh (a thread-block cluster
// per (row, KV head), merged through distributed shared memory), whose
// header says how the loads are issued and the scales folded.
#include "decode_kernel.cuh"

// C entry points, bound with ctypes (ops/kernels/decode_attn.py). ``args``
// holds pointers and strides (in elements; the head dim contiguous);
// q_dtype is 0 for bf16, 1 for f32; args->chunk and args->cluster come from
// the wrapper's plan. Each returns the cudaGetLastError() after its launch.
extern "C" int mosstts_decode_attention(const mosstts::decode::Args* args, int B, int hd,
                                        int q_dtype, void* stream) {
    return mosstts::decode::dispatch<false, false>(args, B, hd, q_dtype, stream);
}

extern "C" int mosstts_decode_attention_q8(const mosstts::decode::Args* args, int B, int hd,
                                           int q_dtype, void* stream) {
    return mosstts::decode::dispatch<true, false>(args, B, hd, q_dtype, stream);
}

// As mosstts_decode_attention_q8, with the scales' type given: s_dtype 0 for
// bf16, 1 for f32.
extern "C" int mosstts_decode_attention_q8t(const mosstts::decode::Args* args, int B, int hd,
                                            int q_dtype, int s_dtype, void* stream) {
    if (s_dtype == mosstts::kBF16)
        return mosstts::decode::dispatch<true, false, __nv_bfloat16>(args, B, hd, q_dtype, stream);
    if (s_dtype == mosstts::kF32)
        return mosstts::decode::dispatch<true, false, float>(args, B, hd, q_dtype, stream);
    return (int)cudaErrorInvalidValue;
}
