// Fused momentum-SGD update and SpecTrain weight prediction for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_update.py::fused_update
// (:35, pallas_call at :52; body _upd_kernel, :22).  Per element, in fp32:
//
//     v' = gamma * v + (1 - gamma) * g        (paper Eq. 1)
//     w' = w - lr * v'                        (Eq. 2, momentum form)
//     w^ = w' - (s * lr) * v'                 (Eq. 4, s steps ahead of w')
//
// with (1 - gamma) and s * lr formed on the host in double, as the Pallas
// kernel does.  w and v are fp32 and updated in place; g is fp32 or bf16;
// w^ is fp32 or bf16 and is written only where its pointer is not null.
//
// One launch updates a whole group of tensors that share (lr, gamma, s):
// a pipeline stage's parameter tree, or the outer (embedding/head) tree.
// The group's table of pointers and element counts travels by value in
// the kernel's parameters (at most MAX_TENSORS entries, ~3.1 KB), so no
// device-side table has to be written per tick even though the gradient
// tensors are new every tick.  Each tensor is cut into chunks of CHUNK
// elements; block b finds its tensor in the table's prefix of chunk
// counts and walks its chunk with 256 threads, neighbouring threads on
// neighbouring elements.  Sizes and offsets are 64-bit: a stage's tree,
// or the whole 8-layer granite-8b (exactly 2^31 parameters), overflows
// 32 bits.
//
// What bounds it on an H100: it does ~6 FLOPs per element and moves 24
// bytes per element (w, v, g read; w', v', w^ written, all fp32), so it
// is bound by HBM bandwidth, 3.35 TB/s.  What this simple design leaves
// for later: loads are 4-byte scalar (no 16-byte vector loads), and a
// block handles one fixed chunk rather than a persistent grid-stride walk.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int MAX_TENSORS = 64;
constexpr int NT = 256;                 // threads per block
constexpr int PER_THREAD = 16;          // elements per thread per block
constexpr long long CHUNK = static_cast<long long>(NT) * PER_THREAD;

struct Table {
    float* w[MAX_TENSORS];
    float* v[MAX_TENSORS];
    const void* g[MAX_TENSORS];
    void* what[MAX_TENSORS];
    long long n[MAX_TENSORS];
    long long first_block[MAX_TENSORS + 1];   // prefix of chunk counts
    int count;
    float lr, gamma, one_minus_gamma, s_lr;
};

__device__ __forceinline__ float load(const float* p, long long i) {
    return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
    return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float x) {
    p[i] = x;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i,
                                      float x) {
    p[i] = __float2bfloat16(x);
}

template <typename G, typename W>
__global__ void __launch_bounds__(NT) fused_update_kernel(const Table t) {
    const long long blk = blockIdx.x;
    int e = 0;
    while (e + 1 < t.count && t.first_block[e + 1] <= blk) ++e;
    const long long n = t.n[e];
    const long long base = (blk - t.first_block[e]) * CHUNK;
    float* w = t.w[e];
    float* v = t.v[e];
    const G* g = static_cast<const G*>(t.g[e]);
    W* what = static_cast<W*>(t.what[e]);
#pragma unroll 4
    for (int j = 0; j < PER_THREAD; ++j) {
        const long long i = base + static_cast<long long>(j) * NT +
                            threadIdx.x;
        if (i >= n) break;
        // _rn intrinsics: no FMA contraction, so every product and sum
        // rounds where the plain version's separate operations round
        const float v2 = __fadd_rn(__fmul_rn(t.gamma, v[i]),
                                   __fmul_rn(t.one_minus_gamma, load(g, i)));
        const float w2 = __fsub_rn(w[i], __fmul_rn(t.lr, v2));
        v[i] = v2;
        w[i] = w2;
        if (what != nullptr)
            store(what, i, __fsub_rn(w2, __fmul_rn(t.s_lr, v2)));
    }
}

template <typename G, typename W>
int launch(const Table& t, long long blocks, cudaStream_t stream) {
    fused_update_kernel<G, W><<<static_cast<unsigned>(blocks), NT, 0,
                                stream>>>(t);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_fused_update_max_tensors() { return MAX_TENSORS; }

// w, v, g, what: arrays of `count` device pointers (what entries may be
// null); n: element counts.  g_dtype / what_dtype: 0 = fp32, 1 = bf16.
// Returns a cudaError_t (0 on success); asynchronous on `stream`.
extern "C" int repro_fused_update(
    void* const* w, void* const* v, const void* const* g, void* const* what,
    const long long* n, int count, int g_dtype, int what_dtype,
    double lr, double gamma, double s, void* stream) {
    if (count < 1 || count > MAX_TENSORS)
        return static_cast<int>(cudaErrorInvalidValue);
    Table t;
    long long blocks = 0;
    for (int e = 0; e < count; ++e) {
        if (n[e] < 1) return static_cast<int>(cudaErrorInvalidValue);
        t.w[e] = static_cast<float*>(w[e]);
        t.v[e] = static_cast<float*>(v[e]);
        t.g[e] = g[e];
        t.what[e] = what[e];
        t.n[e] = n[e];
        t.first_block[e] = blocks;
        blocks += (n[e] + CHUNK - 1) / CHUNK;
    }
    t.first_block[count] = blocks;
    t.count = count;
    t.lr = static_cast<float>(lr);
    t.gamma = static_cast<float>(gamma);
    t.one_minus_gamma = static_cast<float>(1.0 - gamma);
    t.s_lr = static_cast<float>(s * lr);
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (g_dtype == 0 && what_dtype == 0)
        return launch<float, float>(t, blocks, st);
    if (g_dtype == 0 && what_dtype == 1)
        return launch<float, __nv_bfloat16>(t, blocks, st);
    if (g_dtype == 1 && what_dtype == 0)
        return launch<__nv_bfloat16, float>(t, blocks, st);
    if (g_dtype == 1 && what_dtype == 1)
        return launch<__nv_bfloat16, __nv_bfloat16>(t, blocks, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
