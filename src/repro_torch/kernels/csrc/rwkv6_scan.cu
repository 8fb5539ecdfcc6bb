// RWKV-6 WKV recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6_scan.py::rwkv6_scan
// (body _wkv_kernel).  It computes what that kernel computes, y and the
// final state S_T from S0, for r, k, v, w [b, s, h, hd], u [h, hd] and
// S0 [b, h, hd, hd] (key x value):
//
//   y_t = r_t (S + diag(u) k_t v_t^T),    S <- diag(w_t) S + k_t v_t^T
//
// exact at any decay in [0, 1].  The Pallas kernel evaluates a chunk at
// once by dividing r and k by the running decay product inside the
// chunk; that holds only while the product stays well inside fp32 (w in
// [~0.5, 1) over chunks <= 64), and RWKV-6 at random initialisation draws
// w = exp(-exp(logw)) down to ~1e-30.  No kernel here divides by a decay
// or a product of decays: every factor is a product of decays, formed by
// multiplying them.
//
// Layouts are the model side's, read in place through strides: r, k, v
// (fp32 or bf16) and w (fp32) are [b, s, h, hd] with a contiguous last
// dimension.  u is contiguous fp32 [h, hd], S0 and S_T contiguous fp32
// [b, h, hd, hd]; S_T may be S0 itself (every block reads its part of S0
// before it writes the same part of S_T, and no two blocks share one), so
// a cache slot is updated in place.  y is written contiguous [b, s, h, hd]
// in r's type.  Value column j of the state evolves on its own, S[:, j] <-
// w_t * S[:, j] + k_t v_t[j], so every kernel splits a head over blocks by
// value column.  The wrapper (kernels/rwkv6_scan.py) picks one of three
// kernels by the sequence length s:
//
// * wkv_decode_kernel, s = 1 (each decode step).  The work is reading and
//   writing the 1 MB fp32 state of rwkv6-7b (b 1, 64 heads of 64 x 64);
//   r, k, v, w and u are under 50 KB.  So the bound is bytes and the
//   design is about bytes in flight: a block of two warps owns 16 value
//   columns of a head (256 blocks at b 1, h 64), a warp 8 of them; two
//   neighbouring lanes read one row's 32 bytes (a whole sector) and a
//   lane holds hd / 16 rows, and every load (the state's float4s, the
//   lane's r_i, k_i, w_i, u_i and four v_j) is issued at once, before
//   any arithmetic.  S_T goes back where S0 came from, by the same lane.
//   y_j = sum_i r_i (S_ij + u_i k_i v_j) is a shuffle reduction over the
//   16 lanes that share the columns: no shared memory, no barrier.
//
// * wkv_kernel, 2 <= s < 64 (the serving paths' short prompts): the
//   recurrence one step after another with the state in registers.  A
//   block owns 16 value columns; each column is split over hd / 8 lanes
//   of a warp holding 8 rows each (rows rg, rg + RG, ...), y_t[j] a shuffle
//   reduction over them.  Time runs in tiles of 32 steps staged in shared
//   memory, the next tile's loads issued into registers before the
//   current one is computed.  It is bound by the latency of one step
//   (shared loads, FMAs, the shuffle) times s.
//
// * wkv_scores_kernel + wkv_chunk_kernel, s >= 64 (a long prompt).  The
//   sequential steps are what bound wkv_kernel at s = 2048 (0.75 ms
//   against 0.031 ms of bytes); here the steps become matrix products on
//   the tensor cores.  Time runs in chunks of 64 steps, each in four
//   sub-chunks of 16.  With S the state at sub-chunk I's first step (its
//   reference point) and Q_t = prod_{start(I) <= m < t} w_m, K_s =
//   prod_{s < m < end(I)} w_m, W_I = the sub-chunk's whole product (all
//   per channel, all <= 1, formed by running products):
//
//     y_t = (r_t o Q_t) S + sum_{s < t in I} A_ts v_s + (r_t . (u o k_t)) v_t
//     S  <- diag(W_I) S + (k o K)_I^T v_I
//
//   where A_ts = sum_d r_td k_sd prod_{s<m<t} w_md is the diagonal
//   block, 120 pairs per sub-chunk, formed on the CUDA cores by running
//   products along t.  Those scores depend on the head only, and cost
//   more than the rest of a chunk, so wkv_scores_kernel forms them first
//   for every chunk at once (a block per chunk, head and batch row: 2,048
//   blocks at s = 2048) into a scratch tensor.  wkv_chunk_kernel then
//   walks the chunks in order: a block owns 16 value columns of a head (4
//   warps, each 16 key rows of the state; 256 blocks at b 1, h 64); a
//   chunk's r, k, w, v and scores come in by cp.async (v and the scores
//   through a two-stage ring, the next chunk's loading while this one is
//   computed); the factors are formed in shared memory; and the three
//   products run on mma.sync m16n8k8 TF32 with every fp32-derived operand
//   split into two TF32 parts (3xTF32, scan_mma.cuh), which keeps fp32
//   accuracy (bf16 v is exact in TF32).  The state lives in registers as
//   S^T, the accumulator of (diag(W) S^T + V^T (k o K)) and, through a
//   permuted k axis, the A operand of y^T = S^T (r o Q)^T; the warps'
//   partial y over their key rows meet in shared memory and a warp per
//   sub-chunk adds A_I v_I on the tensor cores.  What bounds it on an
//   H100: the bytes are 102.8 MB at s = 2048 (0.031 ms); the tensor-core
//   work is small; the factors and three block barriers a chunk, in
//   sequence over 32 chunks, are what is left.
//
// Every product and sum is fp32 (the tensor-core ones to 3xTF32).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "scan_mma.cuh"

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
    float* scores;      // the chunked kernel's diagonal scores (scratch)
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

// ---------------------------------------------------------------------------
// s = 1: the decode kernel, bound by the state's bytes

template <typename T, int HD>
__global__ void __launch_bounds__(64) wkv_decode_kernel(Params p) {
    constexpr int RPL = HD / 16;            // state rows per lane
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int cq = lane & 1;                // which float4 of the warp's 8
    const int r0 = lane >> 1;               // rows r0 + 16 i
    const int c0 = blockIdx.x * NC + 8 * warp;
    const int j0 = c0 + 4 * cq;
    const int h = blockIdx.y;
    const int bi = blockIdx.z;
    const long long head = (static_cast<long long>(bi) * p.h + h) * HD * HD;

    // every load at once: the lane's float4 of each of its state rows,
    // then its r_i, k_i, w_i, u_i and v_j0..j0+3
    float4 s4[RPL];
#pragma unroll
    for (int i = 0; i < RPL; ++i)
        s4[i] = *reinterpret_cast<const float4*>(
            p.s0 + head + static_cast<long long>(r0 + 16 * i) * HD + j0);
    const T* R = static_cast<const T*>(p.r) + bi * p.r_sb + h * p.r_sh;
    const T* K = static_cast<const T*>(p.k) + bi * p.k_sb + h * p.k_sh;
    const T* V = static_cast<const T*>(p.v) + bi * p.v_sb + h * p.v_sh;
    const float* W = p.w + bi * p.w_sb + h * p.w_sh;
    float r[RPL], k[RPL], w[RPL], u[RPL], v[4];
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
        const int row = r0 + 16 * i;
        r[i] = to_f32(R[row]);
        k[i] = to_f32(K[row]);
        w[i] = W[row];
        u[i] = p.u[h * HD + row];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = to_f32(V[j0 + q]);

    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
        float S[4] = {s4[i].x, s4[i].y, s4[i].z, s4[i].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const float kv = k[i] * v[q];
            acc[q] = fmaf(r[i], fmaf(u[i], kv, S[q]), acc[q]);
            S[q] = fmaf(w[i], S[q], kv);
        }
        *reinterpret_cast<float4*>(
            p.sT + head + static_cast<long long>(r0 + 16 * i) * HD + j0) =
            make_float4(S[0], S[1], S[2], S[3]);
    }
    // y_j: the sum over the 16 lanes that share the columns
#pragma unroll
    for (int off = 2; off < 32; off <<= 1)
#pragma unroll
        for (int q = 0; q < 4; ++q)
            acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], off);
    if (lane < 2) {
        T* Y = static_cast<T*>(p.y) +
               (static_cast<long long>(bi) * p.h + h) * HD + j0;
#pragma unroll
        for (int q = 0; q < 4; ++q) store(Y + q, acc[q]);
    }
}

// ---------------------------------------------------------------------------
// s >= 64: the chunked kernel on the tensor cores

namespace sm = scan_mma;

constexpr int CH = 64;        // steps per chunk
constexpr int SUB = 16;       // steps per sub-chunk
constexpr int NSUB = CH / SUB;
constexpr int LDV = 24;       // row stride of the v tile (elements)

// The chunk's tiles of r, k and w in shared memory: rows of HD + 16
// elements, so that the diagonal-score threads, which read different rows
// at once, fall in different banks.
template <typename T, int HD>
struct TileSmem {
    static constexpr int LDI = HD + 16;            // r, k, w row stride
    static constexpr int SZ_RK = CH * LDI * sizeof(T);
    static constexpr int OFF_K = SZ_RK;
    static constexpr int OFF_W = 2 * SZ_RK;
    static constexpr int END = OFF_W + CH * LDI * 4;
};

// dynamic shared memory of wkv_scores_kernel<T, HD>, byte offsets
template <typename T, int HD>
struct ScoresSmem {
    static constexpr int OFF_A = TileSmem<T, HD>::END;
    static constexpr int OFF_U = OFF_A + NSUB * SUB * SUB * 4;
    static constexpr int BYTES = OFF_U + HD * 4;
};

// dynamic shared memory of wkv_chunk_kernel<T, HD>, byte offsets.  r, k
// and w have one buffer (they are dead once a chunk's factors are
// formed, and the next chunk's load into them then); v and the scores
// (read to the end of a chunk) have two stages.
template <typename T, int HD>
struct ChunkSmem {
    static constexpr int LD = HD + 8;              // rq, kk row stride
    static constexpr int SZ_V = CH * LDV * sizeof(T);
    static constexpr int SZ_A = NSUB * SUB * SUB * 4;
    static constexpr int OFF_V = TileSmem<T, HD>::END;     // two stages
    static constexpr int OFF_A = OFF_V + 2 * SZ_V;         // two stages
    static constexpr int OFF_RQ = OFF_A + 2 * SZ_A;
    static constexpr int OFF_KK = OFF_RQ + CH * LD * 4;
    static constexpr int OFF_WS = OFF_KK + CH * LD * 4;
    static constexpr int BYTES = OFF_WS + NSUB * HD * 4;
};

// 16 channels of one row: 4 runs of 4 consecutive ones, STRIDE apart
template <int STRIDE>
__device__ __forceinline__ void load16(const float* p, float (&x)[16]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float4 f = *reinterpret_cast<const float4*>(p + i * STRIDE);
        x[4 * i] = f.x;
        x[4 * i + 1] = f.y;
        x[4 * i + 2] = f.z;
        x[4 * i + 3] = f.w;
    }
}

template <int STRIDE>
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&x)[16]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const uint2 u = *reinterpret_cast<const uint2*>(p + i * STRIDE);
        const float2 lo = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 hi = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u.y));
        x[4 * i] = lo.x;
        x[4 * i + 1] = lo.y;
        x[4 * i + 2] = hi.x;
        x[4 * i + 3] = hi.y;
    }
}

// sum_c x_c y_c over 16 channels in four independent chains
__device__ __forceinline__ float dot16(const float (&x)[16],
                                       const float (&y)[16]) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 16; ++c) a[c & 3] = fmaf(x[c], y[c], a[c & 3]);
    return (a[0] + a[1]) + (a[2] + a[3]);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the sum over the N lanes of a channel group (consecutive lanes)
template <int N>
__device__ __forceinline__ float group_sum(float x, unsigned mask) {
#pragma unroll
    for (int off = 1; off < N; off <<= 1)
        x += __shfl_xor_sync(mask, x, off);
    return x;
}

// one chunk's r, k and w tiles (all channels) into shared memory by
// 16-byte cp.async, rows past s zero-filled (not committed)
template <typename T, int HD, int NT>
__device__ __forceinline__ void issue_tiles(const Params& p, const T* R,
                                            const T* K, const float* Wg,
                                            T* rs, T* ks, float* ws, int t0,
                                            int tid) {
    constexpr int LDI = TileSmem<T, HD>::LDI;
    constexpr int EPC = 16 / sizeof(T);
    constexpr int RROW = HD / EPC;
    for (int e = tid; e < CH * RROW; e += NT) {
        const int t = e / RROW, c = (e % RROW) * EPC;
        const bool in = t0 + t < p.s;
        const long long tt = in ? t0 + t : 0;
        sm::cp_async16(rs + t * LDI + c, R + tt * p.r_ss + c, in);
        sm::cp_async16(ks + t * LDI + c, K + tt * p.k_ss + c, in);
    }
    constexpr int WROW = HD / 4;
    for (int e = tid; e < CH * WROW; e += NT) {
        const int t = e / WROW, c = (e % WROW) * 4;
        const bool in = t0 + t < p.s;
        const long long tt = in ? t0 + t : 0;
        sm::cp_async16(ws + t * LDI + c, Wg + tt * p.w_ss + c, in);
    }
}

// The diagonal blocks of one chunk, a block per (chunk, head, batch row),
// all chunks at once before wkv_chunk_kernel walks them in order: A[I][t]
// [s] = sum_d r_td k_sd prod_{s<m<t} w_md (s < t), with kf = k_s o prod w
// carried along t by running products, the bonus A[I][t][t] = sum_d r_td
// u_d k_td, and 0 above the diagonal, into scores [b, h, chunk, I, t, s].
// They depend on the head only, not on the value columns, so one block
// forms them for the four column blocks of wkv_chunk_kernel.  A thread
// takes steps s and 15 - s (15 t-steps together) of one sub-chunk over 16
// channels, four runs of 4 spread over the row (so the lanes reading two
// rows at once use distinct banks); the next row is loaded, and a step's
// sum over the channel groups (shuffles) runs, while the next step's
// products are formed.
template <typename T, int HD>
__global__ void __launch_bounds__(2 * HD) wkv_scores_kernel(Params p) {
    using TL = TileSmem<T, HD>;
    using L = ScoresSmem<T, HD>;
    constexpr int NT = 2 * HD;
    constexpr int NDG = HD / 16;            // channel groups of 16
    constexpr int LDI = TL::LDI;
    constexpr int RUN = 4 * NDG;            // channel stride of the runs
    extern __shared__ __align__(16) unsigned char smem[];
    T* rs = reinterpret_cast<T*>(smem);
    T* ks = reinterpret_cast<T*>(smem + TL::OFF_K);
    float* ws = reinterpret_cast<float*>(smem + TL::OFF_W);
    float* Ad = reinterpret_cast<float*>(smem + L::OFF_A);
    float* us = reinterpret_cast<float*>(smem + L::OFF_U);
    const int tid = threadIdx.x, lane = tid & 31;
    const int ch = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
    const T* R = static_cast<const T*>(p.r) + bi * p.r_sb + h * p.r_sh;
    const T* K = static_cast<const T*>(p.k) + bi * p.k_sb + h * p.k_sh;
    const float* Wg = p.w + bi * p.w_sb + h * p.w_sh;
    issue_tiles<T, HD, NT>(p, R, K, Wg, rs, ks, ws, ch * CH, tid);
    sm::cp_async_commit();
    for (int d = tid; d < HD; d += NT) us[d] = p.u[h * HD + d];
    for (int e = tid; e < NSUB * SUB * SUB; e += NT) Ad[e] = 0.f;
    sm::cp_async_wait<0>();
    __syncthreads();

    const int dg = tid % NDG;
    const int I = (tid / (2 * NDG)) % NSUB;
    const int pair = 2 * (tid / (8 * NDG)) + (tid / NDG) % 2;
    const int t0 = I * SUB, d0 = 4 * dg;
    const unsigned mask = NDG == 1 ? (1u << lane)
        : ((1u << NDG) - 1u) << (lane & ~(NDG - 1));
    float* A = Ad + I * SUB * SUB;
    float uu[16];
    load16<RUN>(us + d0, uu);
#pragma unroll 1
    for (int side = 0; side < 2; ++side) {
        const int s = side ? SUB - 1 - pair : pair;
        float kf[16], xr[16], xw[16], uk[16];
        load16<RUN>(ks + (t0 + s) * LDI + d0, kf);
        load16<RUN>(rs + (t0 + s) * LDI + d0, xr);
#pragma unroll
        for (int c = 0; c < 16; ++c) uk[c] = uu[c] * kf[c];
        float prev = dot16(xr, uk);             // the bonus, at t = s
        if (s + 1 < SUB) {
            load16<RUN>(rs + (t0 + s + 1) * LDI + d0, xr);
            load16<RUN>(ws + (t0 + s + 1) * LDI + d0, xw);
        }
#pragma unroll 1
        for (int t = s + 1; t < SUB; ++t) {
            const float acc = dot16(xr, kf);
#pragma unroll
            for (int c = 0; c < 16; ++c) kf[c] *= xw[c];
            if (t + 1 < SUB) {
                load16<RUN>(rs + (t0 + t + 1) * LDI + d0, xr);
                load16<RUN>(ws + (t0 + t + 1) * LDI + d0, xw);
            }
            prev = group_sum<NDG>(prev, mask);
            if (dg == 0) A[(t - 1) * SUB + s] = prev;
            prev = acc;
        }
        prev = group_sum<NDG>(prev, mask);
        if (dg == 0) A[(SUB - 1) * SUB + s] = prev;
    }
    __syncthreads();
    float4* out = reinterpret_cast<float4*>(
        p.scores + ((static_cast<long long>(bi) * p.h + h) * gridDim.x + ch) *
                       NSUB * SUB * SUB);
    for (int e = tid; e < NSUB * SUB * SUB / 4; e += NT)
        out[e] = reinterpret_cast<const float4*>(Ad)[e];
}

template <typename T, int HD>
__global__ void __launch_bounds__(2 * HD) wkv_chunk_kernel(Params p) {
    using L = ChunkSmem<T, HD>;
    using TL = TileSmem<T, HD>;
    constexpr int NW = HD / 16;             // warps: 16 state rows each
    constexpr int NT = 32 * NW;
    constexpr int LD = L::LD, LDI = TL::LDI;
    constexpr bool EX = sizeof(T) == 2;     // bf16 v is exact in TF32
    constexpr int EPC = 16 / sizeof(T);     // elements per 16-byte copy
    extern __shared__ __align__(16) unsigned char smem[];
    T* rs = reinterpret_cast<T*>(smem);
    T* ks = reinterpret_cast<T*>(smem + TL::OFF_K);
    float* ws = reinterpret_cast<float*>(smem + TL::OFF_W);
    float* rq = reinterpret_cast<float*>(smem + L::OFF_RQ);
    float* kk = reinterpret_cast<float*>(smem + L::OFF_KK);
    float* Wsub = reinterpret_cast<float*>(smem + L::OFF_WS);
    auto vS = [&](int st) {
        return reinterpret_cast<T*>(smem + L::OFF_V + st * L::SZ_V);
    };
    auto aS = [&](int st) {
        return reinterpret_cast<float*>(smem + L::OFF_A + st * L::SZ_A);
    };

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, tg = lane & 3;
    const int c0 = blockIdx.x * NC;         // the block's value columns
    const int h = blockIdx.y;
    const int bi = blockIdx.z;
    const int dw = 16 * warp;               // the warp's state rows (keys)
    const T* R = static_cast<const T*>(p.r) + bi * p.r_sb + h * p.r_sh;
    const T* K = static_cast<const T*>(p.k) + bi * p.k_sb + h * p.k_sh;
    const T* V = static_cast<const T*>(p.v) + bi * p.v_sb + h * p.v_sh;
    const float* Wg = p.w + bi * p.w_sb + h * p.w_sh;
    const long long head = (static_cast<long long>(bi) * p.h + h) * HD * HD;
    const int nch = (p.s + CH - 1) / CH;

    const float* Sc = p.scores +
        (static_cast<long long>(bi) * p.h + h) * nch * L::SZ_A / 4;

    // one chunk's r, k, w (all channels), v (the block's columns) and
    // diagonal scores, v and scores into stage st, one commit group; rows
    // past s are zero-filled
    auto issue = [&](int ch, int st) {
        const int t0 = ch * CH;
        issue_tiles<T, HD, NT>(p, R, K, Wg, rs, ks, ws, t0, tid);
        for (int e = tid; e < L::SZ_A / 16; e += NT)
            sm::cp_async16(aS(st) + 4 * e,
                           Sc + static_cast<long long>(ch) * L::SZ_A / 4 +
                               4 * e, true);
        constexpr int VROW = NC / EPC;
        for (int e = tid; e < CH * VROW; e += NT) {
            const int t = e / VROW, c = (e % VROW) * EPC;
            const bool in = t0 + t < p.s;
            const long long tt = in ? t0 + t : 0;
            sm::cp_async16(vS(st) + t * LDV + c, V + tt * p.v_ss + c0 + c,
                           in);
        }
        sm::cp_async_commit();
    };

    // S^T in registers, in the accumulator layout: rows j (the block's
    // value columns), columns d = dw + 8 nt + 2 tg (+1)
    float st[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int j = g + 8 * (e >> 1);
            const int d = dw + 8 * nt + 2 * tg + (e & 1);
            st[nt][e] = p.s0[head + static_cast<long long>(d) * HD + c0 + j];
        }
    issue(0, 0);

    T* Y = static_cast<T*>(p.y) +
           (static_cast<long long>(bi) * p.s * p.h + h) * HD + c0;
    const long long y_ss = static_cast<long long>(p.h) * HD;

    for (int ch = 0; ch < nch; ++ch) {
        const int cur = ch & 1;
        sm::cp_async_wait<0>();
        __syncthreads();        // this chunk's tiles; the last one consumed
        const int nv = min(CH, p.s - ch * CH);
        const T* vs = vS(cur);

        // factors per (sub-chunk, channel), by running products: the query
        // side rq = r o prod_{start <= m < t} w_m, the key side kk = k o
        // prod_{s < m < end} w_m, and the sub-chunk's whole product (a
        // step's values loaded before the products)
        for (int e = tid; e < NSUB * HD; e += NT) {
            const int I = e / HD, d = e % HD, t0 = I * SUB;
            float rv[SUB], kv[SUB], wv[SUB];
#pragma unroll
            for (int t = 0; t < SUB; ++t) {
                rv[t] = to_f32(rs[(t0 + t) * LDI + d]);
                kv[t] = to_f32(ks[(t0 + t) * LDI + d]);
                // a masked step (past s) decays nothing
                wv[t] = t0 + t < nv ? ws[(t0 + t) * LDI + d] : 1.f;
            }
            float fac = 1.f;
#pragma unroll
            for (int t = 0; t < SUB; ++t) {
                rq[(t0 + t) * LD + d] = rv[t] * fac;
                fac *= wv[t];
            }
            fac = 1.f;
#pragma unroll
            for (int t = SUB - 1; t >= 0; --t) {
                kk[(t0 + t) * LD + d] = kv[t] * fac;
                fac *= wv[t];
            }
            Wsub[I * HD + d] = fac;
        }

        __syncthreads();
        // r, k and w are consumed: the next chunk loads during this one
        if (ch + 1 < nch) issue(ch + 1, cur ^ 1);

        // the sub-chunks in order, each warp on its 16 state rows: y^T
        // partials over those rows from the state at the reference point,
        // then the state to the next reference point
#pragma unroll 1
        for (int I = 0; I < NSUB; ++I) {
            const int t0 = I * SUB;
            float yp[2][2][4] = {};     // [kt]: two mma chains a tile
#pragma unroll
            for (int kt = 0; kt < 2; ++kt) {
                const float av[4] = {st[kt][0], st[kt][2], st[kt][1],
                                     st[kt][3]};
                sm::Frag<4> a;
                sm::split<false>(a, av);
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
                    const float2 q = *reinterpret_cast<const float2*>(
                        rq + (t0 + 8 * nt + g) * LD + dw + 8 * kt + 2 * tg);
                    const float bv[2] = {q.x, q.y};
                    sm::Frag<2> b;
                    sm::split<false>(b, bv);
                    sm::mma3<false, false>(yp[kt][nt], a, b);
                }
            }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
                const int d = dw + 8 * nt + 2 * tg;
                const float w0 = Wsub[I * HD + d], w1 = Wsub[I * HD + d + 1];
                st[nt][0] *= w0;
                st[nt][1] *= w1;
                st[nt][2] *= w0;
                st[nt][3] *= w1;
            }
#pragma unroll
            for (int k8 = 0; k8 < 2; ++k8) {
                const int s0 = t0 + 8 * k8;
                const float av[4] = {to_f32(vs[(s0 + tg) * LDV + g]),
                                     to_f32(vs[(s0 + tg) * LDV + g + 8]),
                                     to_f32(vs[(s0 + tg + 4) * LDV + g]),
                                     to_f32(vs[(s0 + tg + 4) * LDV + g + 8])};
                sm::Frag<4> a;
                sm::split<EX>(a, av);
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
                    const int d = dw + 8 * nt + g;
                    const float bv[2] = {kk[(s0 + tg) * LD + d],
                                         kk[(s0 + tg + 4) * LD + d]};
                    sm::Frag<2> b;
                    sm::split<false>(b, bv);
                    sm::mma3<EX, false>(st[nt], a, b);
                }
            }
            // the y^T partial [16 j x 16 t] goes where this warp's part of
            // rq for this sub-chunk was (rows t0 + j, columns dw + t)
            __syncwarp();
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
                const int t = 8 * nt + 2 * tg;
                *reinterpret_cast<float2*>(rq + (t0 + g) * LD + dw + t) =
                    make_float2(yp[0][nt][0] + yp[1][nt][0],
                                yp[0][nt][1] + yp[1][nt][1]);
                *reinterpret_cast<float2*>(rq + (t0 + g + 8) * LD + dw + t) =
                    make_float2(yp[0][nt][2] + yp[1][nt][2],
                                yp[0][nt][3] + yp[1][nt][3]);
            }
        }
        __syncthreads();

        // y_I = the warps' partials + A_I v_I on the tensor cores, a warp
        // per sub-chunk: rows t, columns j, k over the steps s
#pragma unroll 1
        for (int I = warp; I < NSUB; I += NW) {
            const int t0 = I * SUB;
            float acc[2][4];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int t = g + 8 * (e >> 1);
                    const int j = 8 * nt + 2 * tg + (e & 1);
                    float y = 0.f;
#pragma unroll
                    for (int i = 0; i < NW; ++i)
                        y += rq[(t0 + j) * LD + 16 * i + t];
                    acc[nt][e] = y;
                }
            const float* A = aS(cur) + I * SUB * SUB;
#pragma unroll
            for (int k8 = 0; k8 < 2; ++k8) {
                const int sk = 8 * k8 + tg;
                const float av[4] = {A[g * SUB + sk], A[(g + 8) * SUB + sk],
                                     A[g * SUB + sk + 4],
                                     A[(g + 8) * SUB + sk + 4]};
                sm::Frag<4> a;
                sm::split<false>(a, av);
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
                    const float bv[2] = {
                        to_f32(vs[(t0 + sk) * LDV + 8 * nt + g]),
                        to_f32(vs[(t0 + sk + 4) * LDV + 8 * nt + g])};
                    sm::Frag<2> b;
                    sm::split<EX>(b, bv);
                    sm::mma3<false, EX>(acc[nt], a, b);
                }
            }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int t = t0 + g + 8 * half;
                    if (t < nv)
                        store2(Y + static_cast<long long>(ch * CH + t) * y_ss +
                                   8 * nt + 2 * tg,
                               acc[nt][2 * half], acc[nt][2 * half + 1]);
                }
        }
    }

#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int j = g + 8 * (e >> 1);
            const int d = dw + 8 * nt + 2 * tg + (e & 1);
            p.sT[head + static_cast<long long>(d) * HD + c0 + j] = st[nt][e];
        }
}

// ---------------------------------------------------------------------------
// launches

enum Variant { STEP = 0, DECODE = 1, CHUNK = 2 };

template <typename T, int HD>
int launch(const Params& p, int variant, cudaStream_t stream) {
    const dim3 grid(HD / NC, p.h, p.b);
    if (variant == STEP) {
        wkv_kernel<T, HD><<<grid, threads<HD>(), 0, stream>>>(p);
    } else if (variant == DECODE) {
        if (p.s != 1) return static_cast<int>(cudaErrorInvalidValue);
        wkv_decode_kernel<T, HD><<<grid, 64, 0, stream>>>(p);
    } else if (variant == CHUNK) {
        // the diagonal scores of every chunk, then the walk over chunks
        constexpr int sbytes = ScoresSmem<T, HD>::BYTES;
        constexpr int bytes = ChunkSmem<T, HD>::BYTES;
        cudaError_t e = cudaFuncSetAttribute(
            wkv_scores_kernel<T, HD>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, sbytes);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(
                wkv_chunk_kernel<T, HD>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e != cudaSuccess) return static_cast<int>(e);
        const dim3 sgrid((p.s + CH - 1) / CH, p.h, p.b);
        wkv_scores_kernel<T, HD><<<sgrid, 2 * HD, sbytes, stream>>>(p);
        e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
        wkv_chunk_kernel<T, HD><<<grid, 2 * HD, bytes, stream>>>(p);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
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
long long chunk_bytes(int hd, int which) {
    switch (hd) {
        case 16: return which ? ScoresSmem<T, 16>::BYTES
                              : ChunkSmem<T, 16>::BYTES;
        case 32: return which ? ScoresSmem<T, 32>::BYTES
                              : ChunkSmem<T, 32>::BYTES;
        case 64: return which ? ScoresSmem<T, 64>::BYTES
                              : ChunkSmem<T, 64>::BYTES;
        default: return -1;
    }
}

}  // namespace

// variant: 0 = stepwise (wkv_kernel), 1 = decode (wkv_decode_kernel, s
// must be 1; S0 and S_T 16-byte aligned), 2 = chunked (wkv_scores_kernel
// then wkv_chunk_kernel; r, k, v, w and their batch, sequence and head
// strides 16-byte aligned; scores a 16-byte aligned fp32 scratch of b h
// ceil(s / 64) 1024 elements, unused by the other variants).  dtype (of
// r, k, v and y): 0 = fp32, 1 = bf16.  Strides are in elements, (batch,
// seq, head) for each of r, k, v, w.  Returns a cudaError_t (0 on
// success); the launches are asynchronous on ``stream``.
extern "C" int repro_rwkv6_scan(
    int variant, const void* r, const void* k, const void* v,
    const void* w, const void* u, const void* s0, void* y, void* sT,
    void* scores, int dtype, int hd, int b, int s, int h,
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
    p.scores = static_cast<float*>(scores);
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
    if (dtype == 0) return launch_dim<float>(p, hd, variant, st);
    if (dtype == 1) return launch_dim<__nv_bfloat16>(p, hd, variant, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory per block of the chunked kernel (which = 0) or of
// the scores kernel (which = 1), in bytes (dtype as above), or -1 for a
// head size they do not take.
extern "C" long long repro_rwkv6_scan_chunk_smem_bytes(int dtype, int hd,
                                                       int which) {
    return dtype == 0 ? chunk_bytes<float>(hd, which)
                      : chunk_bytes<__nv_bfloat16>(hd, which);
}
