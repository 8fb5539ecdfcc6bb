// RWKV-6 WKV recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6_scan.py::rwkv6_scan
// (body _wkv_kernel).  It computes what that kernel computes, y and the
// final state S_T from S0, for r, k, v, w [b, s, h, hd], u [h, hd] and
// S0 [b, h, hd, hd] (key x value):
//
//   y_t = r_t (S + diag(u) k_t v_t^T),    S <- diag(w_t) S + k_t v_t^T
//
// but as the recurrence itself, one step after another.  The Pallas kernel
// evaluates a chunk at once by dividing r and k by the running decay
// product inside the chunk; that is exact only while the product stays
// well inside fp32 (w in [~0.5, 1) over chunks <= 64), and RWKV-6 at
// random initialisation draws w = exp(-exp(logw)) down to ~1e-30.  Here no
// product is ever divided out, so the result is exact at any w in (0, 1].
//
// Layouts are the model side's, read in place through strides: r, k, v
// (fp32 or bf16) and w (fp32) are [b, s, h, hd] with a contiguous last
// dimension.  u is contiguous fp32 [h, hd], S0 and S_T contiguous fp32
// [b, h, hd, hd]; S_T may be S0 itself (each thread reads its entries of
// S0 before the time loop and writes the same entries of S_T after it,
// and no two threads share one), so a cache slot is updated in place.  y
// is written contiguous [b, s, h, hd] in r's type.  Any
// s >= 1 is taken, so one kernel serves prefill and the one-token decode
// step.  Every product and sum is fp32.
//
// Design (simple first).  Value column j of the state evolves on its own:
// S[:, j] <- w_t * S[:, j] + k_t v_t[j], and y_t[j] = sum_i r_t[i] (S[i, j]
// + u[i] k_t[i] v_t[j]).  A block owns 16 value columns of one (batch row,
// head), so a head of 64 spreads over 4 blocks (256 blocks at rwkv6-7b's
// b 1, h 64, against 132 SMs).  Each column is split over hd / 8 lanes of a
// warp, each holding 8 rows of S[:, j] in registers (rows rg, rg + RG, ...,
// so the lanes of a warp read distinct shared-memory banks); y_t[j] is a
// shuffle reduction over those lanes.  Time runs in tiles of 32 steps: the
// tile's r, k, w (all hd rows, broadcast to the block) and v (the block's
// columns) are staged in shared memory with coalesced loads, and the next
// tile's loads are issued into registers before the current tile is
// computed, so their latency hides behind 32 steps of arithmetic.
//
// What bounds it on an H100: per token and head it reads 3 hd + hd values,
// does ~4 hd^2 fp32 operations and writes hd values, so it is far below
// the card's balance point at any s; but the steps are sequential, so at
// b h = 64 it is bound by the latency of one step (shared loads, FMAs and
// the shuffle reduction) times s.  What this design leaves: a chunked
// tensor-core form with log-space renormalisation that does the in-chunk
// work as matrix products, and TMA tile loads.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int RPT = 8;    // state rows per thread
constexpr int NC = 16;    // value columns per block
constexpr int TT = 32;    // time steps per staged tile

struct Params {
    const void* r;
    const void* k;
    const void* v;
    const float* w;
    const float* u;
    const float* s0;
    void* y;
    float* sT;
    int b, s, h;
    long long r_sb, r_ss, r_sh;
    long long k_sb, k_ss, k_sh;
    long long v_sb, v_ss, v_sh;
    long long w_sb, w_ss, w_sh;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
}

template <int HD>
__host__ __device__ constexpr int threads() { return (HD / RPT) * NC; }

template <typename T, int HD>
__global__ void __launch_bounds__((HD / RPT) * NC) wkv_kernel(Params p) {
    constexpr int RG = HD / RPT;            // lanes sharing one column
    constexpr int NT = threads<HD>();
    constexpr int LD = TT * HD / NT;        // r, k, w loads per thread/tile
    constexpr int LV = TT * NC / NT;        // v loads per thread per tile
    static_assert(TT * HD % NT == 0 && TT * NC % NT == 0, "tile split");
    static_assert(NT % 32 == 0 && 32 % RG == 0, "lane groups");
    __shared__ float rs[TT][HD];
    __shared__ float ks[TT][HD];
    __shared__ float ws[TT][HD];
    __shared__ float vs[TT][NC];

    const int tid = threadIdx.x;
    const int rg = tid % RG;                // rows rg + RG * i
    const int cl = tid / RG;                // column within the block
    const int c0 = blockIdx.x * NC;
    const int j = c0 + cl;                  // value column
    const int h = blockIdx.y;
    const int bi = blockIdx.z;

    const T* R = static_cast<const T*>(p.r) + bi * p.r_sb + h * p.r_sh;
    const T* K = static_cast<const T*>(p.k) + bi * p.k_sb + h * p.k_sh;
    const T* V = static_cast<const T*>(p.v) + bi * p.v_sb + h * p.v_sh;
    const float* W = p.w + bi * p.w_sb + h * p.w_sh;
    const long long head = (static_cast<long long>(bi) * p.h + h) * HD * HD;

    float S[RPT], u[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int row = rg + RG * i;
        S[i] = p.s0[head + static_cast<long long>(row) * HD + j];
        u[i] = p.u[h * HD + row];
    }

    // one tile's loads, held in registers until the tile is staged
    float pr[LD], pk[LD], pw[LD], pv[LV];
    auto fetch = [&](int t0) {
#pragma unroll
        for (int n = 0; n < LD; ++n) {
            const int e = tid + n * NT;
            const int t = t0 + e / HD, c = e % HD;
            const bool in = t < p.s;
            pr[n] = in ? to_f32(R[t * p.r_ss + c]) : 0.f;
            pk[n] = in ? to_f32(K[t * p.k_ss + c]) : 0.f;
            pw[n] = in ? W[t * p.w_ss + c] : 0.f;
        }
#pragma unroll
        for (int n = 0; n < LV; ++n) {
            const int e = tid + n * NT;
            const int t = t0 + e / NC, c = e % NC;
            pv[n] = t < p.s ? to_f32(V[t * p.v_ss + c0 + c]) : 0.f;
        }
    };

    T* Y = static_cast<T*>(p.y) +
           (static_cast<long long>(bi) * p.s * p.h + h) * HD + j;
    const long long y_ss = static_cast<long long>(p.h) * HD;

    fetch(0);
    for (int t0 = 0; t0 < p.s; t0 += TT) {
        __syncthreads();                    // the previous tile is consumed
#pragma unroll
        for (int n = 0; n < LD; ++n) {
            const int e = tid + n * NT;
            rs[e / HD][e % HD] = pr[n];
            ks[e / HD][e % HD] = pk[n];
            ws[e / HD][e % HD] = pw[n];
        }
#pragma unroll
        for (int n = 0; n < LV; ++n) {
            const int e = tid + n * NT;
            vs[e / NC][e % NC] = pv[n];
        }
        __syncthreads();
        if (t0 + TT < p.s) fetch(t0 + TT);  // in flight during this tile
        const int nt = min(TT, p.s - t0);
        for (int tt = 0; tt < nt; ++tt) {
            const float vj = vs[tt][cl];
            float acc = 0.f;
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
                const int row = rg + RG * i;
                const float kv = ks[tt][row] * vj;
                acc = fmaf(rs[tt][row], fmaf(u[i], kv, S[i]), acc);
                S[i] = fmaf(ws[tt][row], S[i], kv);
            }
#pragma unroll
            for (int off = 1; off < RG; off <<= 1)
                acc += __shfl_xor_sync(0xffffffffu, acc, off);
            if (rg == 0) store(Y + (t0 + tt) * y_ss, acc);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i)
        p.sT[head + static_cast<long long>(rg + RG * i) * HD + j] = S[i];
}

template <typename T, int HD>
int launch(const Params& p, cudaStream_t stream) {
    const dim3 grid(HD / NC, p.h, p.b);
    wkv_kernel<T, HD><<<grid, threads<HD>(), 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const Params& p, int hd, cudaStream_t stream) {
    switch (hd) {
        case 16: return launch<T, 16>(p, stream);
        case 32: return launch<T, 32>(p, stream);
        case 64: return launch<T, 64>(p, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// dtype (of r, k, v and y): 0 = fp32, 1 = bf16.  Strides are in elements,
// (batch, seq, head) for each of r, k, v, w.  Returns a cudaError_t (0 on
// success); the launch is asynchronous on ``stream``.
extern "C" int repro_rwkv6_scan(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, void* y, void* sT,
    int dtype, int hd, int b, int s, int h,
    long long r_sb, long long r_ss, long long r_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long w_sb, long long w_ss, long long w_sh, void* stream) {
    Params p;
    p.r = r;
    p.k = k;
    p.v = v;
    p.w = static_cast<const float*>(w);
    p.u = static_cast<const float*>(u);
    p.s0 = static_cast<const float*>(s0);
    p.y = y;
    p.sT = static_cast<float*>(sT);
    p.b = b;
    p.s = s;
    p.h = h;
    p.r_sb = r_sb;
    p.r_ss = r_ss;
    p.r_sh = r_sh;
    p.k_sb = k_sb;
    p.k_ss = k_ss;
    p.k_sh = k_sh;
    p.v_sb = v_sb;
    p.v_ss = v_ss;
    p.v_sh = v_sh;
    p.w_sb = w_sb;
    p.w_ss = w_ss;
    p.w_sh = w_sh;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch_dim<float>(p, hd, st);
    if (dtype == 1) return launch_dim<__nv_bfloat16>(p, hd, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
