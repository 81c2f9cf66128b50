// Device-resident decode loops: the JAX package's lax.while_loop and
// fori_loop programs (mosstts_tpu/models/delay.py delay_generate_on_device and
// delay_decode_until_event, the servers' _block_fn, _event_fn and _drain_fn)
// as CUDA graphs whose loop runs on the card. A parent graph holds an
// init-condition kernel and a conditional WHILE node; the node's body holds a
// child-graph node with one captured decode step (or frame) and a condition
// kernel that evaluates the loop's condition on the device after the step and
// sets the node's handle (cudaGraphSetConditional). The host launches the
// parent once and reads the counters back once.
//
// Replaces no Pallas kernel: the kernels here are the loop's control, not its
// work. Condition kernels:
//   kind 0 (generate): min(step) < limit & ~all(stopped)
//   kind 1 (event):    i < limit & ~any(watch & (stopped | i >= budget))
//   kind 2 (block):    i < limit
//   kind 3 (drain):    (qi < qn | any(active)) & ~any(active & pos >= attend) & i < limit
// The drain (JAX's _drain_fn) adds an admission kernel (first free slot by
// argmin, the request's sampling row, key, budget and bookkeeping, and one IF
// handle per prompt bucket), per bucket an IF node whose body gathers the
// staged prompt row into the bucket's prefill buffers and replays the
// bucket's admission graph (its prefill, then the splice of the admission
// state's row into the slot the admission kernel wrote), then the decode
// step, then a collect kernel that writes stopped slots' frames into their
// request's result row.
//
// The row copy (copy_rows_kernel) is every server admission's splice, the
// JAX servers' _insert_fn, _insert_paged_fn, _table_entry_fn, _table_clear_fn,
// _insert_local_row and _splice_rt_rows: a list of segments, each a row of a
// destination at an index read from an int32 control word on the device
// (the slot, a page, a table entry), so one graph serves every slot. A row
// index outside [0, bound) is dropped, as JAX's scatter with mode="drop"
// drops the Realtime k bucket's padding rows.
//
// text_lazy (mosstts_tpu/models/delay.py _sample_text_lazy, a lax.cond): a
// condition kernel reads sampling_text & ~is_audio over the rows and sets the
// handles of two IF nodes on complementary conditions (the full-vocab branch,
// the 2-column branch), added to the capturing graph of a decode step with
// each branch's own captured graph as the body's child.
//
// Bound on the H100: latency. Each control kernel reads a few bytes a slot;
// the splice moves one cache lane (bytes). Design: one block, threads over the
// slots, block-wide or/and reductions; the splice a grid-strided 16-byte copy.
#include <cuda_runtime.h>
#include <stdint.h>

namespace mosstts {
namespace loop {

// ctrl words (int32, device): the loop's counters, written by the host before
// a launch and read back after it
enum { kI = 0, kLimit = 1, kCond = 2, kQi = 3, kQn = 4, kSlot = 5, kAdmQi = 6, kCtrl = 12 };

struct CondArgs {
    int kind, B;
    const uint8_t* flags;  // (n_flags,) bool stop flags
    int n_flags, invert;   // invert: the flags say "unfinished"
    const int32_t* step;   // (n_step,) per-row step counters (kind 0)
    int n_step;
    int32_t* ctrl;
    const int32_t* watch;   // (B,) kind 1
    const int32_t* budget;  // (B,) kind 1: steps left
    const uint8_t* active;  // (B,) kind 3
    const int32_t* pos;     // (B,) kind 3
    int attend;             // kind 3
};

// One copy: n_outer x n_mid chunks of `chunk` bytes; the chunk (o, m) of the
// destination at dst + idx * dst_idx + o * dst_outer + m * dst_mid (idx =
// ctrl[dst_word], or 0 when dst_word < 0), of the source alike; src 0 writes
// zeros. A destination index outside [0, bound) drops the segment.
struct Seg {
    int64_t dst, src, n_outer, n_mid, chunk, dst_outer, src_outer, dst_mid, src_mid, dst_idx,
        src_idx, bound;
    int32_t dst_word, src_word;
};

// text_lazy's condition: sampling_text, is_audio (B,) bool; counts (3,) int32:
// full-branch runs, 2-column runs, the last decision
struct LazyArgs {
    const uint8_t* sampling_text;
    const uint8_t* is_audio;
    int B;
    int32_t* counts;
};

constexpr int kMaxSamp = 8;

struct DrainArgs {
    int32_t* ctrl;
    int slots, n_buckets;
    uint8_t* active;
    int32_t* slot_rid;
    int32_t* budget;
    const int32_t* qbucket;
    const int32_t* qbudget;
    const int64_t* qkeys;  // (nqcap, 2)
    int64_t* small_rng;    // (1, 2): the admission state's key
    const unsigned long long* handles;  // (n_buckets,) IF handles
    // sampling rows, 4-byte and 1-byte fields: slot row, staged (nqcap,) and
    // the admission's 0-dim value
    int n_f32, n_u8;
    float* f_dst[kMaxSamp];
    const float* f_src[kMaxSamp];
    float* f_pre[kMaxSamp];
    uint8_t* u_dst[kMaxSamp];
    const uint8_t* u_src[kMaxSamp];
    uint8_t* u_pre[kMaxSamp];
    // collect
    const uint8_t* is_stopping;
    const int32_t* step;
    const int32_t* out;   // (slots, out_row) int32
    int32_t* results;     // (nqcap + 1, out_row)
    int32_t* rsteps;      // (nqcap + 1,)
    int64_t out_row;
};

}  // namespace loop
}  // namespace mosstts

using namespace mosstts::loop;

namespace {

__device__ __forceinline__ bool stopped(const CondArgs& a, int b) {
    return (a.flags[b] != 0) != (a.invert != 0);
}

__global__ void loop_cond_kernel(cudaGraphConditionalHandle handle, CondArgs a, int advance) {
    const int i = a.ctrl[kI] + advance;
    const int limit = a.ctrl[kLimit];
    int any_lt = 0, all_stop = 1, any_ev = 0, any_act = 0, any_pos = 0;
    for (int b = threadIdx.x; b < a.n_flags && a.kind == 0; b += blockDim.x)
        all_stop &= stopped(a, b);
    for (int b = threadIdx.x; b < a.n_step && a.kind == 0; b += blockDim.x)
        any_lt |= a.step[b] < limit;
    for (int b = threadIdx.x; b < a.B && a.kind == 1; b += blockDim.x)
        any_ev |= a.watch[b] && (stopped(a, b) || i >= a.budget[b]);
    for (int b = threadIdx.x; b < a.B && a.kind == 3; b += blockDim.x) {
        any_act |= a.active[b] != 0;
        any_pos |= a.active[b] != 0 && a.pos[b] >= a.attend;
    }
    any_lt = __syncthreads_or(any_lt);
    all_stop = __syncthreads_and(all_stop);
    any_ev = __syncthreads_or(any_ev);
    any_act = __syncthreads_or(any_act);
    any_pos = __syncthreads_or(any_pos);
    if (threadIdx.x == 0) {
        int cond;
        if (a.kind == 0) cond = any_lt && !all_stop;
        else if (a.kind == 1) cond = i < limit && !any_ev;
        else if (a.kind == 2) cond = i < limit;
        else cond = (a.ctrl[kQi] < a.ctrl[kQn] || any_act) && !any_pos && i < limit;
        a.ctrl[kI] = i;
        a.ctrl[kCond] = cond;
        cudaGraphSetConditional(handle, cond ? 1u : 0u);
    }
}

// dst[b] = staged[b, i]: a frame's fed column (the Realtime text tokens)
__global__ void feed_kernel(const int64_t* staged, int64_t stride, int64_t* dst, int B,
                            const int32_t* ctrl) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b < B) dst[b] = staged[b * stride + ctrl[kI]];
}

__global__ void copy_rows_kernel(const Seg* segs, const int32_t* ctrl) {
    const Seg s = segs[blockIdx.y];
    const int64_t di = s.dst_word >= 0 ? ctrl[s.dst_word] : 0;
    if (di < 0 || di >= s.bound) return;  // JAX's mode="drop"
    const int64_t si = s.src_word >= 0 ? ctrl[s.src_word] : 0;
    char* dst = reinterpret_cast<char*>(s.dst) + di * s.dst_idx;
    const char* src = s.src ? reinterpret_cast<const char*>(s.src) + si * s.src_idx : nullptr;
    const bool vec = ((s.chunk | s.dst_outer | s.src_outer | s.dst_mid | s.src_mid
                       | reinterpret_cast<int64_t>(dst) | reinterpret_cast<int64_t>(src)) & 15) == 0;
    const int64_t unit = vec ? 16 : 1, per = s.chunk / unit, total = s.n_outer * s.n_mid * per;
    for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; t < total;
         t += (int64_t)gridDim.x * blockDim.x) {
        const int64_t c = t / per, u = (t % per) * unit, o = c / s.n_mid, m = c % s.n_mid;
        char* d = dst + o * s.dst_outer + m * s.dst_mid + u;
        const char* r = src ? src + o * s.src_outer + m * s.src_mid + u : nullptr;
        if (vec) {
            *reinterpret_cast<int4*>(d) = r ? *reinterpret_cast<const int4*>(r) : make_int4(0, 0, 0, 0);
        } else {
            *d = r ? *r : 0;
        }
    }
}

// any(sampling_text & ~is_audio): the full branch's handle takes it, the
// 2-column branch's its negation (set = 0: a launch outside a graph, which
// only counts and records the decision)
__global__ void lazy_cond_kernel(LazyArgs a, cudaGraphConditionalHandle h_full,
                                 cudaGraphConditionalHandle h_cheap, int set) {
    int need = 0;
    for (int b = threadIdx.x; b < a.B; b += blockDim.x)
        need |= a.sampling_text[b] != 0 && a.is_audio[b] == 0;
    need = __syncthreads_or(need);
    if (threadIdx.x == 0) {
        a.counts[need ? 0 : 1] += 1;
        a.counts[2] = need;
        if (set) {
            cudaGraphSetConditional(h_full, need ? 1u : 0u);
            cudaGraphSetConditional(h_cheap, need ? 0u : 1u);
        }
    }
}

__global__ void drain_admit_kernel(DrainArgs a) {
    __shared__ int slot;
    if (threadIdx.x == 0) slot = 0x7fffffff;
    __syncthreads();
    for (int b = threadIdx.x; b < a.slots; b += blockDim.x)
        if (!a.active[b]) atomicMin(&slot, b);
    __syncthreads();
    if (threadIdx.x != 0) return;
    const int qi = a.ctrl[kQi];
    const bool can = slot != 0x7fffffff && qi < a.ctrl[kQn];
    const int bucket = can ? a.qbucket[qi] : -1;
    for (int j = 0; j < a.n_buckets; ++j) cudaGraphSetConditional(a.handles[j], bucket == j);
    if (!can) return;
    a.ctrl[kSlot] = slot;
    a.ctrl[kAdmQi] = qi;
    a.ctrl[kQi] = qi + 1;
    a.active[slot] = 1;
    a.slot_rid[slot] = qi;
    a.budget[slot] = a.qbudget[qi];
    for (int f = 0; f < a.n_f32; ++f) a.f_dst[f][slot] = *a.f_pre[f] = a.f_src[f][qi];
    for (int f = 0; f < a.n_u8; ++f) a.u_dst[f][slot] = *a.u_pre[f] = a.u_src[f][qi];
    a.small_rng[0] = a.qkeys[2 * qi];
    a.small_rng[1] = a.qkeys[2 * qi + 1];
}

// one block per slot: a stopped active slot's frames go to its request's row
__global__ void drain_collect_kernel(DrainArgs a) {
    const int s = blockIdx.x;
    const bool stop = a.active[s] && (a.is_stopping[s] || a.step[s] >= a.budget[s]);
    if (!stop) return;
    const int rid = a.slot_rid[s];
    const int32_t* src = a.out + s * a.out_row;
    int32_t* dst = a.results + rid * a.out_row;
    for (int64_t t = threadIdx.x; t < a.out_row; t += blockDim.x) dst[t] = src[t];
    __syncthreads();
    if (threadIdx.x == 0) {
        a.rsteps[rid] = min(a.step[s], a.budget[s]);
        a.active[s] = 0;
    }
}

#define CHECK(x)                                   \
    do {                                           \
        cudaError_t e_ = (x);                      \
        if (e_ != cudaSuccess) return (int)e_;     \
    } while (0)

cudaError_t add_kernel(cudaGraphNode_t* node, cudaGraph_t g, const cudaGraphNode_t* deps,
                       size_t n_deps, void* func, dim3 grid, dim3 block, void** args) {
    cudaKernelNodeParams p = {};
    p.func = func;
    p.gridDim = grid;
    p.blockDim = block;
    p.kernelParams = args;
    return cudaGraphAddKernelNode(node, g, deps, n_deps, &p);
}

cudaError_t add_conditional(cudaGraphNode_t* node, cudaGraph_t g, const cudaGraphNode_t* deps,
                            size_t n_deps, cudaGraphConditionalHandle h,
                            cudaGraphConditionalNodeType type, cudaGraph_t* body) {
    cudaGraphNodeParams p = {};
    p.type = cudaGraphNodeTypeConditional;
    p.conditional.handle = h;
    p.conditional.type = type;
    p.conditional.size = 1;
    cudaError_t e = cudaGraphAddNode(node, g, deps, n_deps, &p);
    if (e == cudaSuccess) *body = p.conditional.phGraph_out[0];
    return e;
}

}  // namespace

// C entry points, bound with ctypes (ops/kernels/graph_loop.py).

// One run of the condition kernel, on `stream`, in a throwaway graph whose IF
// node (an empty body) takes the handle the kernel sets: the plain-vs-kernel
// check.
extern "C" int mosstts_loop_cond(const CondArgs* a, int advance, void* stream) {
    cudaGraph_t g, body;
    CHECK(cudaGraphCreate(&g, 0));
    cudaGraphConditionalHandle h;
    CondArgs args = *a;
    void* params[] = {&h, &args, &advance};
    cudaGraphNode_t k, c, e;
    cudaGraphExec_t x = nullptr;
    cudaError_t err = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
    if (err == cudaSuccess)
        err = add_kernel(&k, g, nullptr, 0, (void*)loop_cond_kernel, dim3(1), dim3(256), params);
    if (err == cudaSuccess) err = add_conditional(&c, g, &k, 1, h, cudaGraphCondTypeIf, &body);
    if (err == cudaSuccess) err = cudaGraphAddEmptyNode(&e, body, nullptr, 0);
    if (err == cudaSuccess) err = cudaGraphInstantiate(&x, g, 0);
    if (err == cudaSuccess) {
        err = cudaGraphLaunch(x, static_cast<cudaStream_t>(stream));
        cudaError_t s = cudaStreamSynchronize(static_cast<cudaStream_t>(stream));
        if (err == cudaSuccess) err = s;
    }
    if (x) cudaGraphExecDestroy(x);
    cudaGraphDestroy(g);
    return (int)err;
}

// The loop graph: init condition -> WHILE { [feed] -> step graph -> condition }.
// feed_src 0: no feed kernel.
extern "C" int mosstts_loop_build(void* step_graph, const CondArgs* a, const int64_t* feed_src,
                                  int64_t feed_stride, int64_t* feed_dst, void** exec_out) {
    cudaGraph_t g, body;
    CHECK(cudaGraphCreate(&g, 0));
    cudaGraphConditionalHandle h;
    cudaGraphNode_t init, loop, prev = nullptr, child, cond;
    CondArgs args = *a;
    int zero = 0, one = 1, B = a->B;
    void* p0[] = {&h, &args, &zero};
    void* p1[] = {&h, &args, &one};
    void* pf[] = {&feed_src, &feed_stride, &feed_dst, &B, &args.ctrl};
    cudaError_t e = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
    if (e == cudaSuccess)
        e = add_kernel(&init, g, nullptr, 0, (void*)loop_cond_kernel, dim3(1), dim3(256), p0);
    if (e == cudaSuccess)
        e = add_conditional(&loop, g, &init, 1, h, cudaGraphCondTypeWhile, &body);
    if (e == cudaSuccess && feed_src)
        e = add_kernel(&prev, body, nullptr, 0, (void*)feed_kernel, dim3((B + 127) / 128),
                       dim3(128), pf);
    if (e == cudaSuccess)
        e = cudaGraphAddChildGraphNode(&child, body, prev ? &prev : nullptr, prev ? 1 : 0,
                                       static_cast<cudaGraph_t>(step_graph));
    if (e == cudaSuccess)
        e = add_kernel(&cond, body, &child, 1, (void*)loop_cond_kernel, dim3(1), dim3(256), p1);
    cudaGraphExec_t x = nullptr;
    if (e == cudaSuccess) e = cudaGraphInstantiate(&x, g, 0);
    cudaGraphDestroy(g);
    if (e == cudaSuccess) *exec_out = x;
    return (int)e;
}

// The drain graph: init condition -> WHILE { admission -> per bucket j an IF
// { gather segs_j -> admission graph j (prefill and splice) } -> step graph ->
// collect -> condition }. gather[j] are device arrays of Seg; handles_dev a
// device buffer of n_buckets words the builder fills.
extern "C" int mosstts_drain_build(void* step_graph, void** prefill_graphs, const CondArgs* ca,
                                   const DrainArgs* da, const Seg** gather, const int* n_gather,
                                   unsigned long long* handles_dev, void** exec_out) {
    const int nb = da->n_buckets;
    cudaGraph_t g, body;
    CHECK(cudaGraphCreate(&g, 0));
    cudaGraphConditionalHandle h;
    CondArgs cargs = *ca;
    DrainArgs dargs = *da;
    int zero = 0, one = 1;
    void* p0[] = {&h, &cargs, &zero};
    void* p1[] = {&h, &cargs, &one};
    void* pa[] = {&dargs};
    cudaGraphNode_t init, loop, prev, node;
    cudaError_t e = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
    if (e == cudaSuccess)
        e = add_kernel(&init, g, nullptr, 0, (void*)loop_cond_kernel, dim3(1), dim3(256), p0);
    if (e == cudaSuccess)
        e = add_conditional(&loop, g, &init, 1, h, cudaGraphCondTypeWhile, &body);
    if (e == cudaSuccess)
        e = add_kernel(&prev, body, nullptr, 0, (void*)drain_admit_kernel, dim3(1), dim3(128),
                       pa);
    unsigned long long hs[64];
    if (nb > 64) e = cudaErrorInvalidValue;
    for (int j = 0; j < nb && e == cudaSuccess; ++j) {
        cudaGraphConditionalHandle hj;
        cudaGraph_t ib;
        cudaGraphNode_t gat, pre;
        e = cudaGraphConditionalHandleCreate(&hj, body, 0, 0);
        hs[j] = hj;
        if (e == cudaSuccess) e = add_conditional(&node, body, &prev, 1, hj, cudaGraphCondTypeIf, &ib);
        const Seg* gs = gather[j];
        const int32_t* ctrl = ca->ctrl;
        void* pg[] = {&gs, &ctrl};
        if (e == cudaSuccess)
            e = add_kernel(&gat, ib, nullptr, 0, (void*)copy_rows_kernel, dim3(8, n_gather[j]),
                           dim3(256), pg);
        if (e == cudaSuccess)
            e = cudaGraphAddChildGraphNode(&pre, ib, &gat, 1,
                                           static_cast<cudaGraph_t>(prefill_graphs[j]));
        prev = node;
    }
    if (e == cudaSuccess) e = cudaMemcpy(handles_dev, hs, nb * sizeof(hs[0]), cudaMemcpyHostToDevice);
    if (e == cudaSuccess)
        e = cudaGraphAddChildGraphNode(&node, body, &prev, 1, static_cast<cudaGraph_t>(step_graph));
    if (e == cudaSuccess) {
        prev = node;
        e = add_kernel(&node, body, &prev, 1, (void*)drain_collect_kernel, dim3(da->slots),
                       dim3(256), pa);
    }
    if (e == cudaSuccess) {
        prev = node;
        e = add_kernel(&node, body, &prev, 1, (void*)loop_cond_kernel, dim3(1), dim3(256), p1);
    }
    cudaGraphExec_t x = nullptr;
    if (e == cudaSuccess) e = cudaGraphInstantiate(&x, g, 0);
    cudaGraphDestroy(g);
    if (e == cudaSuccess) *exec_out = x;
    return (int)e;
}

extern "C" int mosstts_graph_launch(void* exec, void* stream) {
    return (int)cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream));
}

extern "C" int mosstts_graph_exec_destroy(void* exec) {
    return (int)cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
}

// The drain's admission and collect kernels and the row copy, launched alone
// on `stream` (the plain-vs-kernel checks; the loops run them as graph nodes).
// The admission's IF handles are left alone: handles is read only when
// n_buckets > 0.
extern "C" int mosstts_drain_admit(const DrainArgs* a, void* stream) {
    drain_admit_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(*a);
    return (int)cudaGetLastError();
}

extern "C" int mosstts_drain_collect(const DrainArgs* a, void* stream) {
    drain_collect_kernel<<<a->slots, 256, 0, static_cast<cudaStream_t>(stream)>>>(*a);
    return (int)cudaGetLastError();
}

extern "C" int mosstts_copy_rows(const Seg* segs, int n, const int32_t* ctrl, int blocks,
                                 void* stream) {
    copy_rows_kernel<<<dim3(blocks, n), 256, 0, static_cast<cudaStream_t>(stream)>>>(segs, ctrl);
    return (int)cudaGetLastError();
}

// text_lazy's condition kernel alone on `stream`: counts and records the
// decision (the eager lazy step reads it; the plain-vs-kernel check).
extern "C" int mosstts_lazy_cond(const LazyArgs* a, void* stream) {
    lazy_cond_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(*a, 0, 0, 0);
    return (int)cudaGetLastError();
}

// text_lazy inside a capture under way on `stream`: adds to the capturing
// graph, after the stream's current dependencies, the condition kernel, then
// IF(full) { child: full } -> IF(2 columns) { child: cheap } on the handles the
// kernel sets, and makes the stream's later work depend on the last IF node
// (JAX's lax.cond(need_full, full, cheap)). The branch graphs are cloned.
extern "C" int mosstts_lazy_capture(const LazyArgs* a, void* full, void* cheap, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaStreamCaptureStatus status;
    cudaGraph_t g;
    const cudaGraphNode_t* deps = nullptr;
    size_t n_deps = 0;
    CHECK(cudaStreamGetCaptureInfo(s, &status, nullptr, &g, &deps, &n_deps));
    if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorStreamCaptureUnmatched;
    cudaGraphNode_t before[64];
    if (n_deps > 64) return (int)cudaErrorInvalidValue;
    for (size_t i = 0; i < n_deps; ++i) before[i] = deps[i];
    cudaGraphConditionalHandle hf, hc;
    CHECK(cudaGraphConditionalHandleCreate(&hf, g, 0, 0));
    CHECK(cudaGraphConditionalHandleCreate(&hc, g, 0, 0));
    LazyArgs args = *a;
    int one = 1;
    void* params[] = {&args, &hf, &hc, &one};
    cudaGraphNode_t k, nf, nc, cf, cc;
    cudaGraph_t bf, bc;
    CHECK(add_kernel(&k, g, before, n_deps, (void*)lazy_cond_kernel, dim3(1), dim3(256), params));
    CHECK(add_conditional(&nf, g, &k, 1, hf, cudaGraphCondTypeIf, &bf));
    CHECK(cudaGraphAddChildGraphNode(&cf, bf, nullptr, 0, static_cast<cudaGraph_t>(full)));
    CHECK(add_conditional(&nc, g, &nf, 1, hc, cudaGraphCondTypeIf, &bc));
    CHECK(cudaGraphAddChildGraphNode(&cc, bc, nullptr, 0, static_cast<cudaGraph_t>(cheap)));
    CHECK(cudaStreamUpdateCaptureDependencies(s, &nc, 1, cudaStreamSetCaptureDependencies));
    return 0;
}

extern "C" int mosstts_feed(const int64_t* staged, int64_t stride, int64_t* dst, int B,
                            const int32_t* ctrl, void* stream) {
    feed_kernel<<<(B + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(staged, stride,
                                                                               dst, B, ctrl);
    return (int)cudaGetLastError();
}
