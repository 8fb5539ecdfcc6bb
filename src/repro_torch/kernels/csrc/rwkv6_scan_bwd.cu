// Backward of the RWKV-6 WKV recurrence for Hopper (sm_90a), plain C
// interface.
//
// Replaces no Pallas kernel: the JAX package trains RWKV-6 through its
// jnp oracle (repro/models/ssm.py::rwkv6_wkv_ref, a lax.scan) and XLA
// differentiates that scan.  The port's training path runs the forward
// on the scan kernels of rwkv6_scan.cu, so its backward is this kernel:
// the gradient jax.grad of the oracle computes, written out as the
// backward formulas (kernels/ref.py::rwkv6_bwd_ref).  With G the
// cotangent of S_t, walking t backward from G = dS_T:
//
//   dr_t = (S_{t-1} + diag(u) k_t v_t^T) dy_t
//   dk_t = u o r_t (v_t . dy_t) + G v_t
//   dv_t = (sum_i u_i r_ti k_ti) dy_t + G^T k_t
//   dw_t = rowsum(G o S_{t-1})
//   du  += r_t o k_t (v_t . dy_t)        (over b and t)
//   G   <- diag(w_t) G + r_t dy_t^T,      dS0 = G at the end.
//
// The wrapper (kernels/rwkv6_scan.py) picks one of two variants by s;
// each is exact at any decay in [0, 1] (S_{t-1} is never rebuilt by
// dividing by w_t, which may be 0) and deterministic (no float atomics:
// fixed orders for every sum; du's partials, one a batch row (and chunk),
// added in order by wkv_bwd_du_kernel).
//
// * wkv_bwd_kernel, s < 64: the steps in reverse.  One block owns one
//   (batch row, head): 64 x 64 entries on 512 threads, each thread one key
//   row and 8 neighbouring value columns; row sums are shuffles over a
//   row's 8 lanes, column sums shuffles over the 4 rows of a warp added in
//   warp order in shared memory.  It walks forward from S0 once, storing
//   the state at the start of every tile of TS = 8 steps (a scratch of b
//   h ceil(s / 8) hd^2 fp32), then the tiles in reverse, recomputing each
//   tile's 8 states from its first.  Bound by one step's latency times s.
//
// * wkv_bwd_states_kernel + wkv_bwd_chunk_kernel, s >= 64 (the training
//   path's s = 512): chunks of 64 steps in sub-chunks of 16, the forward's
//   chunked form (rwkv6_scan.cu) differentiated.  Per sub-chunk, with
//   steps local to it, S the state at its first step, G the cotangent of
//   the state after its last, Q_t = prod_{m<t} w_m, K_t = prod_{t<m<16}
//   w_m, W the whole product (per channel, by running products; a masked
//   step past s has decay 1):
//
//     dr_t = Q_t o (S dy_t) + sum_{s<t} k_s o prod_{s<m<t} w (v_s . dy_t)
//            + u o k_t (v_t . dy_t)
//     dk_t = K_t o (G v_t) + sum_{t'>t} r_t' o prod_{t<m<t'} w (v_t .
//            dy_t') + u o r_t (v_t . dy_t)
//     dv   = (k o K) G + A^T dy             (A: the forward's scores)
//     dw_t = K_t Q_t rowsum(G o S) + K_t F_t + Q_t R_t + b_t
//     S    <- diag(W) S + (k o K)^T v,   G <- diag(W) G + (r o Q)^T dy
//
//   with F_t = sum_{s<t} prod_{s<m<t} w k_s (G v_s), R_t = sum_{t'>t}
//   prod_{t<m<t'} w r_t' (S dy_t') and b_t = sum_{t'>t} sum_{s<t} prod_{t<
//   m<t'} w prod_{s<m<t} w r_t' k_s (v_s . dy_t'): rowsum(G_t o S_{t-1})
//   split at step t, so no term takes a quotient.  wkv_bwd_states_kernel
//   walks the chunks, one block per (direction, head, batch row), forward
//   for S and in reverse for G, on mma.sync, into a scratch of 2 b h
//   ceil(s / 64) hd^2 fp32 (134 MB at the tick, against 537 MB of
//   stepwise checkpoints); wkv_bwd_chunk_kernel then forms every chunk's
//   gradients at once, a block per (chunk, head, batch row) on 512
//   threads: 4,096 blocks at the tick, 512 at b 1.  The products that sum
//   over a channel or value column (S dy, G v, dy v^T, dv, the sub-chunks'
//   states and cotangents) run on mma.sync m16n8k8 TF32 with each
//   fp32-derived operand split in two (3xTF32, scan_mma.cuh; bf16 r, k, v,
//   dy are exact in TF32); the scores A, the pairs inside a sub-chunk and
//   b_t (its sum over t' a 16-lane reduce-scatter) on the CUDA cores in
//   fp32, as the forward forms its diagonal blocks.
//
// Layouts: r, k, v (fp32 or bf16), w (fp32) and dy (r's type) are the
// model side's [b, s, h, hd], read through strides with a contiguous last
// dimension; u [h, hd], S0 and dS_T [b, h, hd, hd] contiguous fp32.  dr,
// dk, dv are written contiguous [b, s, h, hd] in r's type, dw contiguous
// fp32 [b, s, h, hd], du [h, hd] and dS0 [b, h, hd, hd] fp32.  Every
// product and sum is fp32.
//
// What bounds it on an H100: at b 8, s 512, 64 heads of 64, bf16, the
// inputs and outputs are 0.39 GB (0.118 ms), the chunked form's
// tensor-core products 14.8 GFLOP, each counted once (0.030 ms at 495
// TFLOP/s; 31.2 GFLOP of mma passes as 3xTF32 runs them), so the bytes
// bound it.  What the design adds on top: the
// sub-chunks' pairs on the CUDA cores (per channel ~120 pairs, three
// walks over them: the scores, b_t, and dr, dk, dw), one 193 KB block an
// SM for the gradient kernel and its four sub-chunks in sequence, the
// walk's 8 dependent chunk steps a block and the boundaries' round trip
// through the scratch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "scan_mma.cuh"

namespace {

constexpr int TS = 8;     // steps per tile (one checkpoint each)
constexpr int EPT = 8;    // state entries per thread: one row, 8 columns

struct Params {
    const void* r;
    const void* k;
    const void* v;
    const float* w;
    const float* u;
    const float* s0;
    const void* dy;
    const float* dsT;
    void* dr;
    void* dk;
    void* dv;
    float* dw;
    float* du;
    float* ds0;
    float* ckpt;        // scratch: b h n_tiles hd hd
    float* du_part;     // scratch: b h du_parts hd
    int b, s, h;
    int du_parts;       // du partials a (batch row, head): 1, or the chunks
    long long r_sb, r_ss, r_sh;
    long long k_sb, k_ss, k_sh;
    long long v_sb, v_ss, v_sh;
    long long w_sb, w_ss, w_sh;
    long long y_sb, y_ss, y_sh;
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
struct Shape {
    static constexpr int NT = HD * HD / EPT;    // threads
    static constexpr int LPR = HD / EPT;        // lanes of one row
    static constexpr int NW = NT / 32;          // warps
    static constexpr int LD = TS * HD / NT;     // tile loads per thread
    static_assert(NT % 32 == 0 && (TS * HD) % NT == 0, "tile split");
};

// dynamic shared memory, in floats
template <int HD>
struct Smem {
    static constexpr int IN = TS * HD;                     // one input tile
    static constexpr int OFF_R = 0, OFF_K = IN, OFF_W = 2 * IN,
                         OFF_V = 3 * IN, OFF_DY = 4 * IN;
    static constexpr int OFF_RED = 5 * IN;                 // [TS][NW][HD]
    static constexpr int OFF_ROW = OFF_RED + TS * Shape<HD>::NW * HD;
    static constexpr int OFF_U = OFF_ROW + 3 * TS * HD;    // [HD]
    static constexpr int OFF_VDY = OFF_U + HD;             // [TS]
    static constexpr int OFF_RUK = OFF_VDY + TS;           // [TS]
    static constexpr int FLOATS = OFF_RUK + TS;
    static constexpr int BYTES = FLOATS * 4;
};

template <typename T, int HD>
__global__ void __launch_bounds__(Shape<HD>::NT)
wkv_bwd_kernel(Params p) {
    using Sh = Shape<HD>;
    using Sm = Smem<HD>;
    constexpr int NT = Sh::NT, LPR = Sh::LPR, LD = Sh::LD;
    extern __shared__ float4 smem4[];
    float* sm = reinterpret_cast<float*>(smem4);
    float* in_r = sm + Sm::OFF_R;
    float* in_k = sm + Sm::OFF_K;
    float* in_w = sm + Sm::OFF_W;
    float* in_v = sm + Sm::OFF_V;
    float* in_dy = sm + Sm::OFF_DY;
    float* red = sm + Sm::OFF_RED;
    float* rowo = sm + Sm::OFF_ROW;
    float* us = sm + Sm::OFF_U;
    float* vdy = sm + Sm::OFF_VDY;
    float* ruk = sm + Sm::OFF_RUK;

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int i = tid / LPR;                // key row
    const int cg = tid % LPR;
    const int j0 = cg * EPT;                // first value column
    const int hh = blockIdx.x;
    const int bi = blockIdx.y;
    const int s = p.s;
    const int n_tiles = (s + TS - 1) / TS;

    const T* R = static_cast<const T*>(p.r) + bi * p.r_sb + hh * p.r_sh;
    const T* K = static_cast<const T*>(p.k) + bi * p.k_sb + hh * p.k_sh;
    const T* V = static_cast<const T*>(p.v) + bi * p.v_sb + hh * p.v_sh;
    const float* W = p.w + bi * p.w_sb + hh * p.w_sh;
    const T* DY = static_cast<const T*>(p.dy) + bi * p.y_sb + hh * p.y_sh;
    const long long head = static_cast<long long>(bi) * p.h + hh;
    float* ck = p.ckpt + head * n_tiles * HD * HD + i * HD + j0;

    for (int c = tid; c < HD; c += NT) us[c] = p.u[hh * HD + c];

    // one tile's loads, in registers until the tile is staged
    float pr[LD], pk[LD], pw[LD], pv[LD], pd[LD];
    auto fetch = [&](int t0, bool all) {
#pragma unroll
        for (int n = 0; n < LD; ++n) {
            const int e = tid + n * NT;
            const int t = t0 + e / HD, c = e % HD;
            const bool in = t < s;
            pk[n] = in ? to_f32(K[t * p.k_ss + c]) : 0.f;
            pw[n] = in ? W[t * p.w_ss + c] : 0.f;
            pv[n] = in ? to_f32(V[t * p.v_ss + c]) : 0.f;
            if (all) {
                pr[n] = in ? to_f32(R[t * p.r_ss + c]) : 0.f;
                pd[n] = in ? to_f32(DY[t * p.y_ss + c]) : 0.f;
            }
        }
    };
    auto stage = [&](bool all) {
#pragma unroll
        for (int n = 0; n < LD; ++n) {
            const int e = tid + n * NT;
            in_k[e] = pk[n];
            in_w[e] = pw[n];
            in_v[e] = pv[n];
            if (all) {
                in_r[e] = pr[n];
                in_dy[e] = pd[n];
            }
        }
    };

    // ---- pass 1: forward from S0, the first state of every tile saved
    float S[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e)
        S[e] = p.s0[head * HD * HD + i * HD + j0 + e];
    fetch(0, false);
    for (int c = 0; c < n_tiles; ++c) {
        float4* dst = reinterpret_cast<float4*>(ck + c * HD * HD);
        dst[0] = make_float4(S[0], S[1], S[2], S[3]);
        dst[1] = make_float4(S[4], S[5], S[6], S[7]);
        __syncthreads();                    // the previous tile is consumed
        stage(false);
        __syncthreads();
        if (c + 1 < n_tiles) fetch((c + 1) * TS, false);
#pragma unroll
        for (int tt = 0; tt < TS; ++tt) {
            const float wi = in_w[tt * HD + i], ki = in_k[tt * HD + i];
#pragma unroll
            for (int e = 0; e < EPT; ++e)
                S[e] = fmaf(wi, S[e], ki * in_v[tt * HD + j0 + e]);
        }
    }

    // ---- pass 2: the tiles in reverse
    float G[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e)
        G[e] = p.dsT[head * HD * HD + i * HD + j0 + e];
    const float ui = us[i];
    float du_acc = 0.f;
    fetch((n_tiles - 1) * TS, true);
    for (int c = n_tiles - 1; c >= 0; --c) {
        const int t0 = c * TS;
        const float4* src = reinterpret_cast<const float4*>(ck + c * HD * HD);
        const float4 a = src[0], b4 = src[1];
        S[0] = a.x; S[1] = a.y; S[2] = a.z; S[3] = a.w;
        S[4] = b4.x; S[5] = b4.y; S[6] = b4.z; S[7] = b4.w;
        __syncthreads();                    // the previous tile is written
        stage(true);
        __syncthreads();
        if (c > 0) fetch(t0 - TS, true);
        // v_t . dy_t and sum_i u_i r_ti k_ti, one warp a step
        for (int tt = warp; tt < TS; tt += Sh::NW) {
            float a1 = 0.f, a2 = 0.f;
            for (int c2 = lane; c2 < HD; c2 += 32) {
                a1 = fmaf(in_v[tt * HD + c2], in_dy[tt * HD + c2], a1);
                a2 = fmaf(us[c2] * in_r[tt * HD + c2], in_k[tt * HD + c2],
                          a2);
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                a1 += __shfl_xor_sync(0xffffffffu, a1, off);
                a2 += __shfl_xor_sync(0xffffffffu, a2, off);
            }
            if (lane == 0) {
                vdy[tt] = a1;
                ruk[tt] = a2;
            }
        }
        // the tile's states S_{t-1}, recomputed from its first
        float Ss[TS][EPT];
#pragma unroll
        for (int tt = 0; tt < TS; ++tt) {
            const float wi = in_w[tt * HD + i], ki = in_k[tt * HD + i];
#pragma unroll
            for (int e = 0; e < EPT; ++e) {
                Ss[tt][e] = S[e];
                S[e] = fmaf(wi, S[e], ki * in_v[tt * HD + j0 + e]);
            }
        }
        __syncthreads();                    // vdy, ruk
#pragma unroll
        for (int tt = TS - 1; tt >= 0; --tt) {
            if (t0 + tt >= s) continue;     // the same for every thread
            const float ri = in_r[tt * HD + i], ki = in_k[tt * HD + i],
                        wi = in_w[tt * HD + i];
            const float vd = vdy[tt];
            float sr = 0.f, sk = 0.f, sw = 0.f, cv[EPT];
#pragma unroll
            for (int e = 0; e < EPT; ++e) {
                const float vj = in_v[tt * HD + j0 + e];
                const float dj = in_dy[tt * HD + j0 + e];
                sr = fmaf(Ss[tt][e], dj, sr);
                sk = fmaf(G[e], vj, sk);
                sw = fmaf(G[e], Ss[tt][e], sw);
                cv[e] = G[e] * ki;
                G[e] = fmaf(wi, G[e], ri * dj);
            }
#pragma unroll
            for (int off = 1; off < LPR; off <<= 1) {
                sr += __shfl_xor_sync(0xffffffffu, sr, off);
                sk += __shfl_xor_sync(0xffffffffu, sk, off);
                sw += __shfl_xor_sync(0xffffffffu, sw, off);
            }
#pragma unroll
            for (int off = LPR; off < 32; off <<= 1)
#pragma unroll
                for (int e = 0; e < EPT; ++e)
                    cv[e] += __shfl_xor_sync(0xffffffffu, cv[e], off);
            if (lane < LPR) {
#pragma unroll
                for (int e = 0; e < EPT; ++e)
                    red[(tt * Sh::NW + warp) * HD + j0 + e] = cv[e];
            }
            if (cg == 0) {
                rowo[(0 * TS + tt) * HD + i] = fmaf(ui * ki, vd, sr);
                rowo[(1 * TS + tt) * HD + i] = fmaf(ui * ri, vd, sk);
                rowo[(2 * TS + tt) * HD + i] = sw;
            }
            du_acc = fmaf(ri * ki, vd, du_acc);
        }
        __syncthreads();
        // the tile's outputs: dr, dk, dw from the rows, dv the warps' sum
        for (int e = tid; e < TS * HD; e += NT) {
            const int tt = e / HD, col = e % HD;
            const int t = t0 + tt;
            if (t >= s) continue;
            float dvj = 0.f;
            for (int wv = 0; wv < Sh::NW; ++wv)
                dvj += red[(tt * Sh::NW + wv) * HD + col];
            dvj = fmaf(ruk[tt], in_dy[tt * HD + col], dvj);
            const long long o = ((static_cast<long long>(bi) * s + t) * p.h
                                 + hh) * HD + col;
            store(static_cast<T*>(p.dr) + o, rowo[(0 * TS + tt) * HD + col]);
            store(static_cast<T*>(p.dk) + o, rowo[(1 * TS + tt) * HD + col]);
            store(static_cast<T*>(p.dv) + o, dvj);
            p.dw[o] = rowo[(2 * TS + tt) * HD + col];
        }
    }
#pragma unroll
    for (int e = 0; e < EPT; ++e)
        p.ds0[head * HD * HD + i * HD + j0 + e] = G[e];
    if (cg == 0) p.du_part[head * HD + i] = du_acc;    // du_parts = 1
}


// du[h, i] = the partials of every batch row (and chunk), added in order
template <int HD>
__global__ void __launch_bounds__(HD) wkv_bwd_du_kernel(Params p) {
    const int i = threadIdx.x, hh = blockIdx.x;
    float acc = 0.f;
    for (int bi = 0; bi < p.b; ++bi) {
        const float* part = p.du_part +
            (static_cast<long long>(bi) * p.h + hh) * p.du_parts * HD + i;
        for (int c = 0; c < p.du_parts; ++c) acc += part[c * HD];
    }
    p.du[hh * HD + i] = acc;
}

// ---------------------------------------------------------------------------
// s >= 64: the chunked form, sub-chunks of 16, on the tensor cores

namespace sm = scan_mma;

constexpr int CH = 64;              // steps per chunk
constexpr int SUB = 16;             // steps per sub-chunk
constexpr int NSUB = CH / SUB;
constexpr int CK_THREADS = 512;
constexpr int CK_WARPS = CK_THREADS / 32;

// row padding of a shared tile of T (16-byte rows, banks spread)
template <typename T>
constexpr int pad_of() { return sizeof(T) == 2 ? 8 : 4; }

// dynamic shared memory of wkv_bwd_states_kernel<T, HD>, byte offsets: a
// two-stage ring of a chunk's k (or r), w and v (or dy) rows, the factor
// rows k o K (or r o Q), the sub-chunks' whole products, the state (or
// cotangent)
template <typename T, int HD>
struct WalkSmem {
    static constexpr int LDI = HD + pad_of<T>();       // k, r, v, dy (T)
    static constexpr int LDW = HD + 4;                 // w, factor rows
    static constexpr int LDS = HD + 4;                 // state rows
    static constexpr int OFF_W = CH * LDI * sizeof(T);
    static constexpr int OFF_V = OFF_W + CH * LDW * 4;
    static constexpr int STAGE = OFF_V + CH * LDI * sizeof(T);
    static constexpr int OFF_F = 2 * STAGE;
    static constexpr int OFF_WS = OFF_F + CH * LDW * 4;
    static constexpr int OFF_S = OFF_WS + NSUB * HD * 4;
    static constexpr int BYTES = OFF_S + HD * LDS * 4;
};

// The walk over the chunks (s >= 64), a block per (direction, head, batch
// row), the whole [hd x hd] state, the sub-chunks of 16 in order
// (forward) or in reverse:
//
//   forward:  S <- diag(W_I) S + (k o K)_I^T v_I,   storing S before each
//             chunk
//   reverse:  G <- diag(W_I) G + (r o Q)_I^T dy_I,  storing G after each
//             chunk
//
// (G from dS_T; dS0 = G at the end), with Q_t = prod_{start<=m<t} w_m,
// K_t = prod_{t<m<end} w_m and W_I per channel by running products (the
// forward's factors; a masked step past s has decay 1), the product on
// mma.sync (3xTF32), warp w on 16 state rows and half the columns; the
// next chunk's tiles load (a two-stage cp.async ring) while this one is
// computed.  The boundaries go to the
// scratch: S [b, h, chunk, hd, hd] then G likewise.
template <typename T, int HD>
__global__ void __launch_bounds__(4 * HD) wkv_bwd_states_kernel(Params p) {
    using L = WalkSmem<T, HD>;
    constexpr int NT = 4 * HD, NW = HD / 8, NB = HD / 16;
    constexpr bool EX = sizeof(T) == 2;     // bf16 v, dy: exact in TF32
    constexpr int EPC = 16 / sizeof(T);     // elements per 16-byte copy
    constexpr int LDI = L::LDI, LDW = L::LDW, LDS = L::LDS;
    extern __shared__ __align__(16) unsigned char smem[];
    float* fs = reinterpret_cast<float*>(smem + L::OFF_F);
    float* Wsub = reinterpret_cast<float*>(smem + L::OFF_WS);
    float* st = reinterpret_cast<float*>(smem + L::OFF_S);
    const int tid = threadIdx.x, warp = tid >> 5;
    const bool rev = blockIdx.x == 1;
    const int h = blockIdx.y, bi = blockIdx.z;
    const int nch = (p.s + CH - 1) / CH;
    const T* RK = rev
        ? static_cast<const T*>(p.r) + bi * p.r_sb + h * p.r_sh
        : static_cast<const T*>(p.k) + bi * p.k_sb + h * p.k_sh;
    const long long rk_ss = rev ? p.r_ss : p.k_ss;
    const T* VY = (rev
        ? static_cast<const T*>(p.dy) + bi * p.y_sb + h * p.y_sh
        : static_cast<const T*>(p.v) + bi * p.v_sb + h * p.v_sh);
    const long long vy_ss = rev ? p.y_ss : p.v_ss;
    const float* Wg = p.w + bi * p.w_sb + h * p.w_sh;
    const long long head = static_cast<long long>(bi) * p.h + h;
    const long long plane = static_cast<long long>(HD) * HD;
    float* buf = p.ckpt + (rev ? static_cast<long long>(p.b) * p.h * nch
                                     * plane : 0)
                 + head * nch * plane;
    const float* init = (rev ? p.dsT : p.s0) + head * plane;

    // step c of the walk's chunk: its k (r), w and v (dy) rows into ring
    // stage sg; rows past s zero-filled
    auto issue = [&](int c, int sg) {
        const int t0 = (rev ? nch - 1 - c : c) * CH;
        const int nv = min(CH, p.s - t0);
        unsigned char* base = smem + sg * L::STAGE;
        T* rk = reinterpret_cast<T*>(base);
        float* ws = reinterpret_cast<float*>(base + L::OFF_W);
        T* vy = reinterpret_cast<T*>(base + L::OFF_V);
        constexpr int IROW = HD / EPC, WROW = HD / 4;
        for (int e = tid; e < CH * IROW; e += NT) {
            const int t = e / IROW, cc = (e % IROW) * EPC;
            const bool in = t < nv;
            const long long tt = in ? t0 + t : 0;
            sm::cp_async16(rk + t * LDI + cc, RK + tt * rk_ss + cc, in);
        }
        for (int e = tid; e < CH * WROW; e += NT) {
            const int t = e / WROW, cc = (e % WROW) * 4;
            const bool in = t < nv;
            const long long tt = in ? t0 + t : 0;
            sm::cp_async16(ws + t * LDW + cc, Wg + tt * p.w_ss + cc, in);
        }
        for (int e = tid; e < CH * IROW; e += NT) {
            const int t = e / IROW, cc = (e % IROW) * EPC;
            const bool in = t < nv;
            const long long tt = in ? t0 + t : 0;
            sm::cp_async16(vy + t * LDI + cc, VY + tt * vy_ss + cc, in);
        }
        sm::cp_async_commit();
    };

    for (int e = tid; e < HD * HD; e += NT)
        st[(e / HD) * LDS + e % HD] = init[e];
    issue(0, 0);
    for (int c = 0; c < nch; ++c) {
        const int cur = c & 1;
        const int ch = rev ? nch - 1 - c : c;
        const int nv = min(CH, p.s - ch * CH);
        sm::cp_async_wait<0>();
        __syncthreads();        // this chunk's tiles; the last update written
        if (c + 1 < nch) issue(c + 1, cur ^ 1);
        const unsigned char* base = smem + cur * L::STAGE;
        const T* rk = reinterpret_cast<const T*>(base);
        const float* ws = reinterpret_cast<const float*>(base + L::OFF_W);
        const T* vy = reinterpret_cast<const T*>(base + L::OFF_V);
        // the state at this chunk's boundary: S before it, G after it
        float* dst = buf + static_cast<long long>(ch) * plane;
        for (int e = tid; e < HD * HD; e += NT)
            dst[e] = st[(e / HD) * LDS + e % HD];
        // per (sub-chunk, channel), by running products: k o K (forward)
        // or r o Q (reverse), and the sub-chunk's whole product
        for (int e = tid; e < NSUB * HD; e += NT) {
            const int I = e / HD, d = e % HD, tb = I * SUB;
            float f = 1.f;
#pragma unroll
            for (int q = 0; q < SUB; ++q) {
                const int t = rev ? tb + q : tb + SUB - 1 - q;
                fs[t * LDW + d] = sm::to_f32(rk[t * LDI + d]) * f;
                f *= t < nv ? ws[t * LDW + d] : 1.f;
            }
            Wsub[I * HD + d] = f;
        }
        __syncthreads();
        for (int q = 0; q < NSUB; ++q) {
            const int I = rev ? NSUB - 1 - q : q;
            sm::warp_jobs<HD, HD, NB, NW>(warp, [&](int r0, int j0) {
                float acc[NB][4];
                sm::acc_set(acc, r0, j0, [&](int d, int j) {
                    return Wsub[I * HD + d] * st[d * LDS + j];
                });
                sm::warp_mma<false, EX, NB>(
                    acc, r0, j0, I * SUB, I * SUB + SUB,
                    [&](int d, int t) { return fs[t * LDW + d]; },
                    [&](int t, int j) { return sm::to_f32(vy[t * LDI + j]); });
                __syncwarp();
                sm::acc_each(acc, r0, j0, [&](int d, int j, float x) {
                    st[d * LDS + j] = x;
                });
                __syncwarp();
            });
        }
    }
    __syncthreads();
    if (rev) {
        float* d0 = p.ds0 + head * plane;
        for (int e = tid; e < HD * HD; e += NT)
            d0[e] = st[(e / HD) * LDS + e % HD];
    }
}

// dynamic shared memory of wkv_bwd_chunk_kernel<T, HD>, byte offsets
template <typename T, int HD>
struct ChunkSmem {
    static constexpr int LDI = HD + pad_of<T>();       // r, k, v, dy (T)
    static constexpr int LDW = HD + 4;                 // fp32 rows
    static constexpr int LDE = SUB + 1;                // E, A rows
    static constexpr int SZ_I = CH * LDI * sizeof(T);
    static constexpr int OFF_W = 4 * SZ_I;             // r, k, v, dy first
    static constexpr int OFF_Q = OFF_W + CH * LDW * 4;
    static constexpr int OFF_K = OFF_Q + CH * LDW * 4;
    static constexpr int OFF_S = OFF_K + CH * LDW * 4;         // NSUB states
    static constexpr int OFF_G = OFF_S + NSUB * HD * LDW * 4;
    static constexpr int OFF_YS = OFF_G + HD * LDW * 4;        // dy S^T
    static constexpr int OFF_VG = OFF_YS + SUB * LDW * 4;      // v G^T
    static constexpr int OFF_B = OFF_VG + SUB * LDW * 4;       // b_t
    static constexpr int OFF_E = OFF_B + SUB * LDW * 4;        // dy v^T
    static constexpr int OFF_A = OFF_E + SUB * LDE * 4;        // scores
    static constexpr int OFF_WS = OFF_A + SUB * LDE * 4;
    static constexpr int OFF_U = OFF_WS + NSUB * HD * 4;
    static constexpr int OFF_GS = OFF_U + HD * 4;
    static constexpr int BYTES = OFF_GS + HD * 4;
    static_assert(BYTES <= 232448, "one block's shared memory");
};

// Every chunk's gradients at once (s >= 64), a block per (chunk, head,
// batch row), from S (the state before the chunk) and G (the cotangent
// of the state after it) that wkv_bwd_states_kernel stored.  The
// sub-chunks' states S_I come forward from S and their cotangents
// backward from G, each on mma.sync as in the walk; per sub-chunk (steps
// t local to it, Q, K, W its factors):
//
//   dr_t = Q_t o (S_I dy_t) + sum_{s<t} k_s o prod_{s<m<t} w (v_s . dy_t)
//          + u o k_t (v_t . dy_t)
//   dk_t = K_t o (G_I v_t) + sum_{t'>t} r_t' o prod_{t<m<t'} w (v_t .
//          dy_t') + u o r_t (v_t . dy_t)
//   dv   = (k o K) G_I + A^T dy          (A the forward's scores)
//   dw_t = K_t Q_t rowsum(G_I o S_I) + K_t F_t + Q_t R_t + b_t
//
// with F_t = sum_{s<t} prod_{s<m<t} w k_s (G_I v_s), R_t = sum_{t'>t}
// prod_{t<m<t'} w r_t' (S_I dy_t') and b_t = sum_{t'>t} sum_{s<t}
// prod_{t<m<t'} w prod_{s<m<t} w r_t' k_s (v_s . dy_t'): rowsum(G_t o
// S_{t-1}) split at step t, so every factor is a product of decays (no
// quotient).  The products with a sum over a channel or value column
// (S_I dy, G_I v, dy v^T, dv, the states) run on mma.sync (3xTF32); the
// scores A, the pairs inside the sub-chunk and the recurrences run on
// the CUDA cores in fp32 by running products; b_t with a thread a (t',
// channel) and the sum over t' in shuffles.  du's partial of the chunk
// goes to the scratch, summed by wkv_bwd_du_kernel.
template <typename T, int HD>
__global__ void __launch_bounds__(CK_THREADS, 1)
wkv_bwd_chunk_kernel(Params p) {
    using L = ChunkSmem<T, HD>;
    constexpr int NT = CK_THREADS, NW = CK_WARPS;
    constexpr bool EX = sizeof(T) == 2;     // bf16 r, k, v, dy: exact
    constexpr int EPC = 16 / sizeof(T);
    constexpr int LDI = L::LDI, LDW = L::LDW, LDE = L::LDE;
    constexpr int NBS = HD / 16;            // [HD x HD]: (HD / 16) x 2 jobs
    constexpr int NBS2 = HD / 16;           // [16 x HD]: 2 jobs
    constexpr int NJ = HD / 8;              // column tiles of [16 x HD]
    constexpr int CPG = HD / 16;            // channels of a score thread
    // steps t a thread of the first 256 takes in the dr, dk, dw items
    // (a channel's 16 over 256 / HD threads)
    constexpr int NTT = HD * SUB / 256;
    static_assert(NT == 512 && NTT * 256 / HD == SUB, "item split");
    extern __shared__ __align__(16) unsigned char smem[];
    T* rs = reinterpret_cast<T*>(smem);
    T* ks = reinterpret_cast<T*>(smem + L::SZ_I);
    T* vs = reinterpret_cast<T*>(smem + 2 * L::SZ_I);
    T* ys = reinterpret_cast<T*>(smem + 3 * L::SZ_I);
    float* ws = reinterpret_cast<float*>(smem + L::OFF_W);
    float* Qf = reinterpret_cast<float*>(smem + L::OFF_Q);
    float* Kf = reinterpret_cast<float*>(smem + L::OFF_K);
    float* Sst = reinterpret_cast<float*>(smem + L::OFF_S);
    float* Gs = reinterpret_cast<float*>(smem + L::OFF_G);
    float* YSm = reinterpret_cast<float*>(smem + L::OFF_YS);
    float* VGm = reinterpret_cast<float*>(smem + L::OFF_VG);
    float* Bt = reinterpret_cast<float*>(smem + L::OFF_B);
    float* Em = reinterpret_cast<float*>(smem + L::OFF_E);
    float* As = reinterpret_cast<float*>(smem + L::OFF_A);
    float* Wsub = reinterpret_cast<float*>(smem + L::OFF_WS);
    float* us = reinterpret_cast<float*>(smem + L::OFF_U);
    float* gsv = reinterpret_cast<float*>(smem + L::OFF_GS);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int ch = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
    const int t0 = ch * CH;
    const int nv = min(CH, p.s - t0);
    const int nch = gridDim.x;
    const T* R = static_cast<const T*>(p.r) + bi * p.r_sb + h * p.r_sh;
    const T* K = static_cast<const T*>(p.k) + bi * p.k_sb + h * p.k_sh;
    const T* V = static_cast<const T*>(p.v) + bi * p.v_sb + h * p.v_sh;
    const T* DY = static_cast<const T*>(p.dy) + bi * p.y_sb + h * p.y_sh;
    const float* Wg = p.w + bi * p.w_sb + h * p.w_sh;
    const long long head = static_cast<long long>(bi) * p.h + h;
    const long long plane = static_cast<long long>(HD) * HD;
    const float* Sb = p.ckpt + (head * nch + ch) * plane;
    const float* Gb = Sb + static_cast<long long>(p.b) * p.h * nch * plane;

    // the chunk's r, k, v, dy and w (rows past s zero-filled), S, G, u
    {
        constexpr int IROW = HD / EPC, FROW = HD / 4;
        for (int e = tid; e < CH * IROW; e += NT) {
            const int t = e / IROW, c = (e % IROW) * EPC;
            const bool in = t < nv;
            const long long tt = in ? t0 + t : 0;
            sm::cp_async16(rs + t * LDI + c, R + tt * p.r_ss + c, in);
            sm::cp_async16(ks + t * LDI + c, K + tt * p.k_ss + c, in);
            sm::cp_async16(vs + t * LDI + c, V + tt * p.v_ss + c, in);
            sm::cp_async16(ys + t * LDI + c, DY + tt * p.y_ss + c, in);
        }
        for (int e = tid; e < CH * FROW; e += NT) {
            const int t = e / FROW, c = (e % FROW) * 4;
            const bool in = t < nv;
            const long long tt = in ? t0 + t : 0;
            sm::cp_async16(ws + t * LDW + c, Wg + tt * p.w_ss + c, in);
        }
        for (int e = tid; e < HD * FROW; e += NT) {
            const int r = e / FROW, c = (e % FROW) * 4;
            sm::cp_async16(Sst + r * LDW + c, Sb + r * HD + c, true);
            sm::cp_async16(Gs + r * LDW + c, Gb + r * HD + c, true);
        }
        sm::cp_async_commit();
        for (int d = tid; d < HD; d += NT) us[d] = p.u[h * HD + d];
        sm::cp_async_wait<0>();
        __syncthreads();
        // a masked step (past s) decays nothing
        for (int e = tid; e < (CH - nv) * HD; e += NT)
            ws[(nv + e / HD) * LDW + e % HD] = 1.f;
        __syncthreads();
    }
    // a decay of the chunk (step t, channel d)
    auto wm = [&](int t, int d) { return ws[t * LDW + d]; };
    auto f32 = [](T x) { return sm::to_f32(x); };

    // Q and K per (sub-chunk, channel) by running products, W
    for (int e = tid; e < NSUB * HD; e += NT) {
        const int I = e / HD, d = e % HD, tb = I * SUB;
        float f = 1.f;
#pragma unroll
        for (int q = 0; q < SUB; ++q) {
            Qf[(tb + q) * LDW + d] = f;
            f *= wm(tb + q, d);
        }
        Wsub[I * HD + d] = f;
        f = 1.f;
#pragma unroll
        for (int q = SUB - 1; q >= 0; --q) {
            Kf[(tb + q) * LDW + d] = f;
            f *= wm(tb + q, d);
        }
    }
    __syncthreads();
    // the states at the sub-chunks' first steps
    for (int I = 0; I + 1 < NSUB; ++I) {
        const float* src = Sst + I * HD * LDW;
        float* dst = Sst + (I + 1) * HD * LDW;
        sm::warp_jobs<HD, HD, NBS, NW>(warp, [&](int r0, int c0) {
            float acc[NBS][4];
            sm::acc_set(acc, r0, c0, [&](int d, int j) {
                return Wsub[I * HD + d] * src[d * LDW + j];
            });
            sm::warp_mma<false, EX, NBS>(
                acc, r0, c0, I * SUB, I * SUB + SUB,
                [&](int d, int t) { return f32(ks[t * LDI + d]) * Kf[t * LDW + d]; },
                [&](int t, int j) { return f32(vs[t * LDI + j]); });
            sm::acc_each(acc, r0, c0, [&](int d, int j, float x) {
                dst[d * LDW + j] = x;
            });
        });
        __syncthreads();
    }

    float du_acc = 0.f;                     // channel tid % HD
    for (int I = NSUB - 1; I >= 0; --I) {
        const int tb = I * SUB;
        const float* S = Sst + I * HD * LDW;
        // dy S^T, v G^T ([16 x HD], two jobs each) and dy v^T ([16 x 16])
        // on warps 0-4, beside the scores on warps 8-15
        if (warp < 5) {
            float acc[NBS2][4] = {};
            const int c0 = 8 * NBS2 * (warp & 1);
            if (warp < 2) {
                sm::warp_mma<EX, false, NBS2>(
                    acc, 0, c0, 0, HD,
                    [&](int t, int j) { return f32(ys[(tb + t) * LDI + j]); },
                    [&](int j, int i) { return S[i * LDW + j]; });
                sm::acc_each(acc, 0, c0, [&](int t, int i, float x) {
                    YSm[t * LDW + i] = x;
                });
            } else if (warp < 4) {
                sm::warp_mma<EX, false, NBS2>(
                    acc, 0, c0, 0, HD,
                    [&](int t, int j) { return f32(vs[(tb + t) * LDI + j]); },
                    [&](int j, int i) { return Gs[i * LDW + j]; });
                sm::acc_each(acc, 0, c0, [&](int t, int i, float x) {
                    VGm[t * LDW + i] = x;
                });
            } else {
                float e[2][4] = {};
                sm::warp_mma<EX, EX, 2>(
                    e, 0, 0, 0, HD,
                    [&](int t, int j) { return f32(ys[(tb + t) * LDI + j]); },
                    [&](int j, int s) { return f32(vs[(tb + s) * LDI + j]); });
                sm::acc_each(e, 0, 0, [&](int t, int s, float x) {
                    Em[t * LDE + s] = x;
                });
            }
        }
        // rowsum(G o S_I) per channel, NT / HD threads a row
        {
            constexpr int TPR = NT / HD;
            const int i = tid / TPR, q = tid % TPR;
            float acc = 0.f;
            for (int j = q; j < HD; j += TPR)
                acc = fmaf(Gs[i * LDW + j], S[i * LDW + j], acc);
#pragma unroll
            for (int off = 1; off < TPR; off <<= 1)
                acc += __shfl_xor_sync(0xffffffffu, acc, off);
            if (q == 0) gsv[i] = acc;
        }
        // the scores A[t][s] = sum_d r_td k_sd prod_{s<m<t} w_md (s < t),
        // A[t][t] = sum_d r_td u_d k_td: thread (s, channel group) of the
        // last 256, the groups' sums scattered over the 16 lanes of s
        if (tid >= 256) {
            const int s = (tid - 256) >> 4, cg = tid & 15, d0 = cg * CPG;
            float kf[CPG], uk[CPG], part[SUB];
            sm::load_vec<CPG>(ks + (tb + s) * LDI + d0, kf);
            sm::load_vec<CPG>(us + d0, uk);
#pragma unroll
            for (int c = 0; c < CPG; ++c) uk[c] *= kf[c];
#pragma unroll
            for (int t = 0; t < SUB; ++t) {
                float rv[CPG], wv[CPG];
                sm::load_vec<CPG>(rs + (tb + t) * LDI + d0, rv);
                sm::load_vec<CPG>(ws + (tb + t) * LDW + d0, wv);
                float a = 0.f;
#pragma unroll
                for (int c = 0; c < CPG; ++c)
                    a = fmaf(rv[c], t == s ? uk[c] : kf[c], a);
                part[t] = t >= s ? a : 0.f;
#pragma unroll
                for (int c = 0; c < CPG; ++c)
                    kf[c] = t > s ? kf[c] * wv[c] : kf[c];
            }
            As[cg * LDE + s] = sm::half_warp_scatter_sum(part);
        }
        __syncthreads();

        // dv = (k o K) G_I + A^T dy, rows s of the sub-chunk
        T* DV = static_cast<T*>(p.dv) +
                ((static_cast<long long>(bi) * p.s + t0 + tb) * p.h + h) * HD;
        const long long o_ss = static_cast<long long>(p.h) * HD;
        for (int job = warp; job < NJ; job += NW) {
            float acc[1][4] = {};
            sm::warp_mma<false, false, 1>(
                acc, 0, 8 * job, 0, HD,
                [&](int s, int i) {
                    return f32(ks[(tb + s) * LDI + i]) * Kf[(tb + s) * LDW + i];
                },
                [&](int i, int j) { return Gs[i * LDW + j]; });
            sm::warp_mma<false, EX, 1>(
                acc, 0, 8 * job, 0, SUB,
                [&](int s, int t) { return As[t * LDE + s]; },
                [&](int t, int j) { return f32(ys[(tb + t) * LDI + j]); });
            sm::acc_each(acc, 0, 8 * job, [&](int s, int j, float x) {
                if (tb + s < nv) store(DV + s * o_ss + j, x);
            });
        }
        // b_t: thread (channel d, t' = lane % 16) walks P_t'(m) = sum_{s<m}
        // prod_{s<m'<m} w k_s E[t'][s] over m < t', forms r_t' prod_{m<m'<
        // t'} w P_t'(m) for every m, and the 16 lanes' sums are scattered:
        // lane t' takes b_t' (t' = m)
#pragma unroll 1
        for (int it = tid; it < HD * SUB; it += NT) {
            const int d = it >> 4, tp = it & 15;
            float Pm[SUB], c[SUB], wv[SUB];
            float pr = 0.f;
#pragma unroll
            for (int m = 0; m < SUB; ++m) {
                Pm[m] = pr;
                wv[m] = wm(tb + m, d);
                const float np = fmaf(wv[m], pr, f32(ks[(tb + m) * LDI + d]) *
                                                     Em[tp * LDE + m]);
                pr = m < tp ? np : pr;
            }
            const float rt = f32(rs[(tb + tp) * LDI + d]);
            float fac = 1.f;
#pragma unroll
            for (int m = SUB - 1; m >= 0; --m) {
                const bool on = m < tp;
                c[m] = on ? rt * fac * Pm[m] : 0.f;
                fac = on ? fac * wv[m] : fac;
            }
            Bt[tp * LDW + d] = sm::half_warp_scatter_sum(c);
        }
        __syncthreads();
        // dr, dk, dw: thread (step t, channel d), channels across lanes
        T* DR = static_cast<T*>(p.dr) +
                ((static_cast<long long>(bi) * p.s + t0 + tb) * p.h + h) * HD;
        T* DK = static_cast<T*>(p.dk) +
                ((static_cast<long long>(bi) * p.s + t0 + tb) * p.h + h) * HD;
        float* DW = p.dw +
                ((static_cast<long long>(bi) * p.s + t0 + tb) * p.h + h) * HD;
        if (tid < 256 && tid < HD * SUB) {
            // steps t_j = tid / HD + j 256 / HD (j < NTT) of channel d: the
            // walks over m share each step's k, r, w and sums
            const int d = tid % HD, tq = tid / HD;
            float dr[NTT], F[NTT], dk[NTT], Rr[NTT], fk[NTT], fr[NTT];
#pragma unroll
            for (int j = 0; j < NTT; ++j) {
                dr[j] = F[j] = dk[j] = Rr[j] = 0.f;
                fk[j] = fr[j] = 1.f;
            }
#pragma unroll
            for (int q = 0; q < SUB; ++q) {
                const int md = SUB - 1 - q, mu = q;     // down and up walks
                const float kd = f32(ks[(tb + md) * LDI + d]);
                const float wd = wm(tb + md, d), vg = VGm[md * LDW + d];
                const float ru = f32(rs[(tb + mu) * LDI + d]);
                const float wu = wm(tb + mu, d), yu = YSm[mu * LDW + d];
#pragma unroll
                for (int j = 0; j < NTT; ++j) {
                    const int t = tq + j * (256 / HD);
                    const bool on = md < t;
                    const float kf = on ? kd * fk[j] : 0.f;
                    dr[j] = fmaf(kf, Em[t * LDE + md], dr[j]);
                    F[j] = fmaf(kf, vg, F[j]);
                    fk[j] = on ? fk[j] * wd : fk[j];
                    const bool up = mu > t;
                    const float rf = up ? ru * fr[j] : 0.f;
                    dk[j] = fmaf(rf, Em[mu * LDE + t], dk[j]);
                    Rr[j] = fmaf(rf, yu, Rr[j]);
                    fr[j] = up ? fr[j] * wu : fr[j];
                }
            }
            const float ud = us[d], g = gsv[d];
#pragma unroll
            for (int j = 0; j < NTT; ++j) {
                const int t = tq + j * (256 / HD), row = tb + t;
                const float et = Em[t * LDE + t];
                const float rt = f32(rs[row * LDI + d]);
                const float kt = f32(ks[row * LDI + d]);
                const float qf = Qf[row * LDW + d], kq = Kf[row * LDW + d];
                if (row < nv) {
                    const long long o = t * o_ss + d;
                    store(DR + o, fmaf(qf, YSm[t * LDW + d], dr[j]) +
                                      ud * kt * et);
                    store(DK + o, fmaf(kq, VGm[t * LDW + d], dk[j]) +
                                      ud * rt * et);
                    DW[o] = fmaf(kq * qf, g, fmaf(kq, F[j], fmaf(qf, Rr[j],
                                                 Bt[t * LDW + d])));
                }
                du_acc = fmaf(rt * kt, et, du_acc);
            }
        }
        // meanwhile on warps 8-15 the cotangent at the end of the sub-chunk
        // before (G is read by no item)
        if (I > 0 && warp >= 8) {
            sm::warp_jobs<HD, HD, NBS, NW - 8>(warp - 8, [&](int r0, int c0) {
                float acc[NBS][4];
                sm::acc_set(acc, r0, c0, [&](int i, int j) {
                    return Wsub[I * HD + i] * Gs[i * LDW + j];
                });
                sm::warp_mma<false, EX, NBS>(
                    acc, r0, c0, tb, tb + SUB,
                    [&](int i, int t) { return f32(rs[t * LDI + i]) * Qf[t * LDW + i]; },
                    [&](int t, int j) { return f32(ys[t * LDI + j]); });
                __syncwarp();
                sm::acc_each(acc, r0, c0, [&](int i, int j, float x) {
                    Gs[i * LDW + j] = x;
                });
            });
        }
        __syncthreads();
    }
    // du's partial of the chunk: the threads of a channel added in order
    if (tid < 256) Qf[tid] = du_acc;
    __syncthreads();
    if (tid < HD) {
        float acc = 0.f;
        for (int q = 0; q < 256 / HD; ++q) acc += Qf[q * HD + tid];
        p.du_part[(head * nch + ch) * HD + tid] = acc;
    }
}

// ---------------------------------------------------------------------------
// launches

enum Variant { STEP = 0, CHUNK = 1 };

template <typename T, int HD>
int launch(const Params& p, int variant, cudaStream_t stream) {
    cudaError_t e;
    if (variant == STEP) {
        constexpr int bytes = Smem<HD>::BYTES;
        e = cudaFuncSetAttribute(wkv_bwd_kernel<T, HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
        if (e != cudaSuccess) return static_cast<int>(e);
        wkv_bwd_kernel<T, HD><<<dim3(p.h, p.b), Shape<HD>::NT, bytes,
                                stream>>>(p);
    } else if (variant == CHUNK) {
        // the boundaries, then every chunk's gradients
        constexpr int wbytes = WalkSmem<T, HD>::BYTES;
        constexpr int cbytes = ChunkSmem<T, HD>::BYTES;
        e = cudaFuncSetAttribute(wkv_bwd_states_kernel<T, HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 wbytes);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(
                wkv_bwd_chunk_kernel<T, HD>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, cbytes);
        if (e != cudaSuccess) return static_cast<int>(e);
        wkv_bwd_states_kernel<T, HD><<<dim3(2, p.h, p.b), 4 * HD, wbytes,
                                       stream>>>(p);
        e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
        wkv_bwd_chunk_kernel<T, HD><<<dim3((p.s + CH - 1) / CH, p.h, p.b),
                                      CK_THREADS, cbytes, stream>>>(p);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    wkv_bwd_du_kernel<HD><<<p.h, HD, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const Params& p, int hd, int variant, cudaStream_t stream) {
    switch (hd) {
        case 16: return launch<T, 16>(p, variant, stream);
        case 32: return launch<T, 32>(p, variant, stream);
        case 64: return launch<T, 64>(p, variant, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

template <typename T>
long long chunk_smem(int hd) {
    switch (hd) {
        case 16: return ChunkSmem<T, 16>::BYTES;
        case 32: return ChunkSmem<T, 32>::BYTES;
        case 64: return ChunkSmem<T, 64>::BYTES;
        default: return -1;
    }
}

}  // namespace

// The backward of repro_rwkv6_scan.  variant: 0 = stepwise
// (wkv_bwd_kernel; ckpt an fp32 scratch of b h ceil(s / 8) hd hd
// elements, du_part of b h hd), 1 = chunked, s >= 64
// (wkv_bwd_states_kernel then wkv_bwd_chunk_kernel; ckpt an fp32 scratch
// of 2 b h ceil(s / 64) hd hd elements, the chunks' boundary states and
// cotangents, du_part of b h ceil(s / 64) hd; r, k, v, w, dy and their
// batch, sequence and head strides 16-byte aligned); either then
// wkv_bwd_du_kernel.  dtype (of r, k, v, dy, dr, dk, dv): 0 = fp32, 1 =
// bf16.  Strides are in elements, (batch, seq, head) for each of r, k, v,
// w, dy; ckpt is 16-byte aligned.  Returns a cudaError_t (0 on success);
// the launches are asynchronous on ``stream``.
extern "C" int repro_rwkv6_scan_bwd(
    int variant, const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, const void* dy, const void* dsT,
    void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
    void* ckpt, void* du_part, int dtype, int hd, int b, int s, int h,
    long long r_sb, long long r_ss, long long r_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long w_sb, long long w_ss, long long w_sh,
    long long y_sb, long long y_ss, long long y_sh, void* stream) {
    Params p;
    p.r = r;
    p.k = k;
    p.v = v;
    p.w = static_cast<const float*>(w);
    p.u = static_cast<const float*>(u);
    p.s0 = static_cast<const float*>(s0);
    p.dy = dy;
    p.dsT = static_cast<const float*>(dsT);
    p.dr = dr;
    p.dk = dk;
    p.dv = dv;
    p.dw = static_cast<float*>(dw);
    p.du = static_cast<float*>(du);
    p.ds0 = static_cast<float*>(ds0);
    p.ckpt = static_cast<float*>(ckpt);
    p.du_part = static_cast<float*>(du_part);
    p.b = b;
    p.s = s;
    p.h = h;
    p.du_parts = variant == CHUNK ? (s + CH - 1) / CH : 1;
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
    p.y_sb = y_sb;
    p.y_ss = y_ss;
    p.y_sh = y_sh;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (b < 1 || s < 1 || h < 1 || (variant == CHUNK && s < CH))
        return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 0) return launch_dim<float>(p, hd, variant, st);
    if (dtype == 1) return launch_dim<__nv_bfloat16>(p, hd, variant, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one wkv_bwd_kernel block, in bytes, or -1 for
// a head size it does not take.
extern "C" long long repro_rwkv6_scan_bwd_smem_bytes(int hd) {
    switch (hd) {
        case 16: return Smem<16>::BYTES;
        case 32: return Smem<32>::BYTES;
        case 64: return Smem<64>::BYTES;
        default: return -1;
    }
}

// Dynamic shared memory of one wkv_bwd_chunk_kernel block (dtype as
// above), in bytes, or -1 for a head size it does not take.
extern "C" long long repro_rwkv6_scan_bwd_chunk_smem_bytes(int dtype,
                                                           int hd) {
    return dtype == 0 ? chunk_smem<float>(hd)
                      : chunk_smem<__nv_bfloat16>(hd);
}
