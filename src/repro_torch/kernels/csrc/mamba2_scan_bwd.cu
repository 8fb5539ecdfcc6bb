// Backward of the Mamba-2 SSD recurrence for Hopper (sm_90a), plain C
// interface.
//
// Replaces no Pallas kernel: the JAX package trains Mamba-2 through its
// jnp oracle (repro/models/ssm.py::mamba2_ssd_ref, a lax.scan) and XLA
// differentiates that scan.  The port's training path runs the forward
// on the scan kernels of mamba2_scan.cu, so its backward is this kernel:
// the gradient jax.grad of the oracle computes, written out as the
// backward formulas (kernels/ref.py::mamba2_bwd_ref).  With G the
// cotangent of S_t, walking t backward from G = dS_T:
//
//   G        <- G + dy_t C_t^T
//   dC_t      = S_t^T dy_t
//   dx_t      = dt_t G B_t
//   ddt_t     = x_t . (G B_t)
//   dB_t      = G^T (dt_t x_t)
//   ddecay_t  = sum(G o S_{t-1})
//   G        <- decay_t G,               dS0 = G at the end,
//
// and dB, dC of a B/C group are the sums over its heads.  The wrapper
// (kernels/mamba2_scan.py) picks one of two variants by s; each is exact
// at any decay in [0, 1] (S_{t-1} is never rebuilt by dividing by decay_t,
// which may be 0) and deterministic (no float atomics: fixed orders for
// every sum, each head's dB and dC into an fp32 partial [b, s, h, n] that
// ssd_bwd_group_kernel adds over the group's heads in head order).
//
// * ssd_bwd_kernel, s < 64: the steps in reverse.  One block owns one
//   (batch row, head): 64 x 64 state entries on 512 threads, each thread
//   one p row and 8 neighbouring n columns; row sums are shuffles over a
//   row's 8 lanes, column sums shuffles over the 4 rows of a warp added in
//   warp order in shared memory.  It walks forward from S0 once, storing
//   the state at the start of every tile of TS = 8 steps (a scratch of b
//   h ceil(s / 8) p n fp32), then the tiles in reverse, recomputing each
//   tile's 8 states from its first.  Bound by one step's latency times s.
//
// * ssd_bwd_states_kernel + ssd_bwd_chunk_kernel, s >= 64 (the training
//   path's s = 512): chunks of Q = 64 steps, the forward's chunked form
//   (mamba2_scan.cu) differentiated.  With S the state before a chunk, G
//   the cotangent of the state after it, steps local to the chunk and
//   L_ij = prod_{j<m<=i} a_m, A_i = prod_{m<=i} a_m, T_j = prod_{j<m<Q}
//   a_m (products, never quotients; a masked step past s has decay 1):
//
//     dx    = diag(dt) (((C B^T) o L)^T dy + diag(T) B G^T),
//     ddt_j = x_j . (row j of that bracket)
//     dC    = diag(A) dy S + ((dy x^T) o L o dt) B
//     dB    = ((dy x^T) o L o dt)^T C + diag(T dt) x G
//     G    <- A_63 G + dy^T diag(A) C           (the chunk before's)
//
//   ssd_bwd_states_kernel walks the chunks, one block per (direction,
//   head, batch row), forward for S (S <- A_63 S + (x o T dt)^T B) and in
//   reverse for G, on mma.sync, into a scratch of 2 b h ceil(s / 64) p n
//   fp32 (134 MB at the tick, against 537 MB of stepwise checkpoints);
//   ssd_bwd_chunk_kernel then forms every chunk's gradients at once, a
//   block per (chunk, head, batch row): 4,096 blocks at the tick, 512 at
//   b 1.  ddecay_t = <G_t, S_{t-1}> takes no quotient either: split at t,
//   ddecay_t = A_{t-1} R_t + Z_t + T_t (A_{t-1} <G, S> + F_t), with u_i =
//   C_i . S^T dy_i, R_t = sum_{i>=t} L_it u_i, v_j = dt_j x_j . G B_j,
//   F_t = sum_{j<t} L_{t-1,j} v_j and Z_t = sum_{i>=t} L_it P_i(t), P_i(t)
//   = sum_{j<t} L_{t-1,j} dt_j (dy_i . x_j)(C_i . B_j) a recurrence along
//   row i (a blocked scan over 8 threads, the carries by products).
//   Every product runs on mma.sync m16n8k8 TF32 with each fp32-derived
//   operand split in two (3xTF32, scan_mma.cuh: fp32 accuracy; bf16 x, B,
//   C are exact in TF32).
//
// Layouts: x (fp32 or bf16) [b, s, h, p], dt and decay (fp32) [b, s, h],
// B and C (x's type) [b, s, g, n] (head i reads group i / (h / g); they
// may be strided views of one tensor), dy (fp32) [b, s, h, p], all read
// through strides with a contiguous last dimension; S0 and dS_T
// [b, h, p, n] contiguous fp32.  dx is written contiguous [b, s, h, p] in
// x's type, ddt and ddecay contiguous fp32 [b, s, h], dB and dC
// contiguous [b, s, g, n] in x's type, dS0 [b, h, p, n] fp32.  Every
// product and sum is fp32.
//
// What bounds it on an H100: at zamba2-1.2b's training shape (b 8, s 512,
// 64 heads, p 64, n 64, bf16) its inputs and outputs are 0.16 GB (0.049
// ms), the chunked form's tensor-core products 16.2 GFLOP, each counted
// once (0.033 ms at 495 TFLOP/s), so the bytes bound it.  The mma passes
// as 3xTF32 runs them come to 34.5 GFLOP (0.070 ms), above the bytes:
// the split operands cost the kernel more than the function needs.  What
// the design adds on top: one 154 KB block an SM for the gradient kernel
// (its 16 warps' fragment loads from shared memory and the mma chains,
// reckoned from a clock64 profile of its phases), a walk of 8 dependent
// chunk steps a block for the boundaries, and the boundaries' round trip
// through the scratch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "scan_mma.cuh"

namespace {

constexpr int TS = 8;     // steps per tile (one checkpoint each)
constexpr int EPT = 8;    // state entries per thread: one row, 8 columns

struct Params {
    const void* x;
    const float* dt;
    const float* decay;
    const void* B;
    const void* C;
    const float* s0;
    const float* dy;
    const float* dsT;
    void* dx;
    float* ddt;
    float* ddecay;
    void* dB;
    void* dC;
    float* ds0;
    float* ckpt;        // scratch: b h n_tiles p n
    float* dB_part;     // scratch: b s h n
    float* dC_part;     // scratch: b s h n
    int b, s, h, g;
    long long x_sb, x_ss, x_sh;
    long long dt_sb, dt_ss, dt_sh;
    long long de_sb, de_ss, de_sh;
    long long B_sb, B_ss, B_sg;
    long long C_sb, C_ss, C_sg;
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

template <int P, int N>
struct Shape {
    static constexpr int NT = P * N / EPT;      // threads
    static constexpr int LPR = N / EPT;         // lanes of one row
    static constexpr int NW = NT / 32;          // warps
    static constexpr int LX = TS * P / NT;      // x, dy loads per thread
    static constexpr int LB = (TS * N + NT - 1) / NT;   // B, C loads
    static_assert(NT % 32 == 0 && (TS * P) % NT == 0, "tile split");
};

// dynamic shared memory, in floats
template <int P, int N>
struct Smem {
    static constexpr int OFF_X = 0, OFF_DY = TS * P, OFF_B = 2 * TS * P,
                         OFF_C = 2 * TS * P + TS * N;
    static constexpr int OFF_DT = OFF_C + TS * N;          // [TS]
    static constexpr int OFF_DE = OFF_DT + TS;             // [TS]
    static constexpr int OFF_RED = OFF_DE + TS;            // [TS][NW][2][N]
    static constexpr int OFF_ROW = OFF_RED + TS * Shape<P, N>::NW * 2 * N;
    static constexpr int FLOATS = OFF_ROW + 2 * TS * P;    // [2][TS][P]
    static constexpr int BYTES = FLOATS * 4;
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(Shape<P, N>::NT)
ssd_bwd_kernel(Params p) {
    using Sh = Shape<P, N>;
    using Sm = Smem<P, N>;
    constexpr int NT = Sh::NT, LPR = Sh::LPR, NW = Sh::NW;
    extern __shared__ float4 smem4[];
    float* sm = reinterpret_cast<float*>(smem4);
    float* in_x = sm + Sm::OFF_X;
    float* in_dy = sm + Sm::OFF_DY;
    float* in_B = sm + Sm::OFF_B;
    float* in_C = sm + Sm::OFF_C;
    float* in_dt = sm + Sm::OFF_DT;
    float* in_de = sm + Sm::OFF_DE;
    float* red = sm + Sm::OFF_RED;
    float* rowo = sm + Sm::OFF_ROW;

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int pr_ = tid / LPR;              // p row
    const int cg = tid % LPR;
    const int n0 = cg * EPT;                // first n column
    const int hh = blockIdx.x;
    const int bi = blockIdx.y;
    const int gi = hh / (p.h / p.g);
    const int s = p.s;
    const int n_tiles = (s + TS - 1) / TS;

    const T* X = static_cast<const T*>(p.x) + bi * p.x_sb + hh * p.x_sh;
    const float* DT = p.dt + bi * p.dt_sb + hh * p.dt_sh;
    const float* DE = p.decay + bi * p.de_sb + hh * p.de_sh;
    const T* Bg = static_cast<const T*>(p.B) + bi * p.B_sb + gi * p.B_sg;
    const T* Cg = static_cast<const T*>(p.C) + bi * p.C_sb + gi * p.C_sg;
    const float* DY = p.dy + bi * p.y_sb + hh * p.y_sh;
    const long long head = static_cast<long long>(bi) * p.h + hh;
    float* ck = p.ckpt + head * n_tiles * P * N + pr_ * N + n0;

    // one tile's loads, in registers until the tile is staged
    float px[Sh::LX], pd[Sh::LX], pb[Sh::LB], pc[Sh::LB], pdt = 0.f,
          pde = 0.f;
    auto fetch = [&](int t0, bool all) {
#pragma unroll
        for (int n = 0; n < Sh::LX; ++n) {
            const int e = tid + n * NT;
            const int t = t0 + e / P, c = e % P;
            const bool in = t < s;
            px[n] = in ? to_f32(X[t * p.x_ss + c]) : 0.f;
            if (all) pd[n] = in ? DY[t * p.y_ss + c] : 0.f;
        }
#pragma unroll
        for (int n = 0; n < Sh::LB; ++n) {
            const int e = tid + n * NT;
            const int t = t0 + e / N, c = e % N;
            const bool in = e < TS * N && t < s;
            pb[n] = in ? to_f32(Bg[t * p.B_ss + c]) : 0.f;
            if (all) pc[n] = in ? to_f32(Cg[t * p.C_ss + c]) : 0.f;
        }
        if (tid < TS) {
            const bool in = t0 + tid < s;
            pdt = in ? DT[(t0 + tid) * p.dt_ss] : 0.f;
            pde = in ? DE[(t0 + tid) * p.de_ss] : 0.f;
        }
    };
    auto stage = [&](bool all) {
#pragma unroll
        for (int n = 0; n < Sh::LX; ++n) {
            const int e = tid + n * NT;
            in_x[e] = px[n];
            if (all) in_dy[e] = pd[n];
        }
#pragma unroll
        for (int n = 0; n < Sh::LB; ++n) {
            const int e = tid + n * NT;
            if (e < TS * N) {
                in_B[e] = pb[n];
                if (all) in_C[e] = pc[n];
            }
        }
        if (tid < TS) {
            in_dt[tid] = pdt;
            in_de[tid] = pde;
        }
    };

    // ---- pass 1: forward from S0, the first state of every tile saved
    float S[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e)
        S[e] = p.s0[head * P * N + pr_ * N + n0 + e];
    fetch(0, false);
    for (int c = 0; c < n_tiles; ++c) {
        float4* dst = reinterpret_cast<float4*>(ck + c * P * N);
        dst[0] = make_float4(S[0], S[1], S[2], S[3]);
        dst[1] = make_float4(S[4], S[5], S[6], S[7]);
        __syncthreads();                    // the previous tile is consumed
        stage(false);
        __syncthreads();
        if (c + 1 < n_tiles) fetch((c + 1) * TS, false);
#pragma unroll
        for (int tt = 0; tt < TS; ++tt) {
            const float de = in_de[tt];
            const float dtx = in_dt[tt] * in_x[tt * P + pr_];
#pragma unroll
            for (int e = 0; e < EPT; ++e)
                S[e] = fmaf(de, S[e], dtx * in_B[tt * N + n0 + e]);
        }
    }

    // ---- pass 2: the tiles in reverse
    float G[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e)
        G[e] = p.dsT[head * P * N + pr_ * N + n0 + e];
    fetch((n_tiles - 1) * TS, true);
    for (int c = n_tiles - 1; c >= 0; --c) {
        const int t0 = c * TS;
        const float4* src = reinterpret_cast<const float4*>(ck + c * P * N);
        const float4 a = src[0], b4 = src[1];
        S[0] = a.x; S[1] = a.y; S[2] = a.z; S[3] = a.w;
        S[4] = b4.x; S[5] = b4.y; S[6] = b4.z; S[7] = b4.w;
        __syncthreads();                    // the previous tile is written
        stage(true);
        __syncthreads();
        if (c > 0) fetch(t0 - TS, true);
        // the tile's states S_{t-1}, recomputed from its first
        float Ss[TS][EPT];
#pragma unroll
        for (int tt = 0; tt < TS; ++tt) {
            const float de = in_de[tt];
            const float dtx = in_dt[tt] * in_x[tt * P + pr_];
#pragma unroll
            for (int e = 0; e < EPT; ++e) {
                Ss[tt][e] = S[e];
                S[e] = fmaf(de, S[e], dtx * in_B[tt * N + n0 + e]);
            }
        }
#pragma unroll
        for (int tt = TS - 1; tt >= 0; --tt) {
            if (t0 + tt >= s) continue;     // the same for every thread
            const float de = in_de[tt];
            const float dyp = in_dy[tt * P + pr_];
            const float dtx = in_dt[tt] * in_x[tt * P + pr_];
            float gb = 0.f, dd = 0.f, cb[EPT], cc[EPT];
#pragma unroll
            for (int e = 0; e < EPT; ++e) {
                const float bn = in_B[tt * N + n0 + e];
                const float cn = in_C[tt * N + n0 + e];
                G[e] = fmaf(dyp, cn, G[e]);
                cc[e] = fmaf(de, Ss[tt][e], dtx * bn) * dyp;   // S_t dy
                gb = fmaf(G[e], bn, gb);
                cb[e] = G[e] * dtx;
                dd = fmaf(G[e], Ss[tt][e], dd);
                G[e] *= de;
            }
#pragma unroll
            for (int off = 1; off < LPR; off <<= 1) {
                gb += __shfl_xor_sync(0xffffffffu, gb, off);
                dd += __shfl_xor_sync(0xffffffffu, dd, off);
            }
#pragma unroll
            for (int off = LPR; off < 32; off <<= 1)
#pragma unroll
                for (int e = 0; e < EPT; ++e) {
                    cb[e] += __shfl_xor_sync(0xffffffffu, cb[e], off);
                    cc[e] += __shfl_xor_sync(0xffffffffu, cc[e], off);
                }
            if (lane < LPR) {
#pragma unroll
                for (int e = 0; e < EPT; ++e) {
                    red[((tt * NW + warp) * 2 + 0) * N + n0 + e] = cb[e];
                    red[((tt * NW + warp) * 2 + 1) * N + n0 + e] = cc[e];
                }
            }
            if (cg == 0) {
                rowo[(0 * TS + tt) * P + pr_] = gb;
                rowo[(1 * TS + tt) * P + pr_] = dd;
            }
        }
        __syncthreads();
        // the tile's outputs: dx from the rows, ddt and ddecay the rows'
        // sums, the head's dB and dC partials the warps' sums
        for (int e = tid; e < TS * P; e += NT) {
            const int tt = e / P, col = e % P;
            const int t = t0 + tt;
            if (t >= s) continue;
            const long long o = ((static_cast<long long>(bi) * s + t) * p.h
                                 + hh) * P + col;
            store(static_cast<T*>(p.dx) + o,
                  in_dt[tt] * rowo[(0 * TS + tt) * P + col]);
        }
        for (int tt = tid; tt < TS; tt += NT) {
            const int t = t0 + tt;
            if (t >= s) continue;
            float a1 = 0.f, a2 = 0.f;
            for (int q = 0; q < P; ++q) {
                a1 = fmaf(in_x[tt * P + q], rowo[(0 * TS + tt) * P + q], a1);
                a2 += rowo[(1 * TS + tt) * P + q];
            }
            const long long o = (static_cast<long long>(bi) * s + t) * p.h
                                + hh;
            p.ddt[o] = a1;
            p.ddecay[o] = a2;
        }
        for (int e = tid; e < TS * N; e += NT) {
            const int tt = e / N, col = e % N;
            const int t = t0 + tt;
            if (t >= s) continue;
            float a1 = 0.f, a2 = 0.f;
            for (int wv = 0; wv < NW; ++wv) {
                a1 += red[((tt * NW + wv) * 2 + 0) * N + col];
                a2 += red[((tt * NW + wv) * 2 + 1) * N + col];
            }
            const long long o = ((static_cast<long long>(bi) * s + t) * p.h
                                 + hh) * N + col;
            p.dB_part[o] = a1;
            p.dC_part[o] = a2;
        }
    }
#pragma unroll
    for (int e = 0; e < EPT; ++e)
        p.ds0[head * P * N + pr_ * N + n0 + e] = G[e];
}

// dB and dC of each group: its heads' partials, added in head order
template <typename T, int N>
__global__ void __launch_bounds__(256) ssd_bwd_group_kernel(Params p) {
    const int t = blockIdx.x, bi = blockIdx.y;
    const int rep = p.h / p.g;
    const long long row = static_cast<long long>(bi) * p.s + t;
    for (int e = threadIdx.x; e < p.g * N; e += blockDim.x) {
        const int gi = e / N, col = e % N;
        float a1 = 0.f, a2 = 0.f;
        for (int j = 0; j < rep; ++j) {
            const long long o = (row * p.h + gi * rep + j) * N + col;
            a1 += p.dB_part[o];
            a2 += p.dC_part[o];
        }
        const long long o = (row * p.g + gi) * N + col;
        store(static_cast<T*>(p.dB) + o, a1);
        store(static_cast<T*>(p.dC) + o, a2);
    }
}


// ---------------------------------------------------------------------------
// s >= 64: the chunked form on the tensor cores

namespace sm = scan_mma;

constexpr int CH = 64;              // steps per chunk
constexpr int WALK_THREADS = 256;
constexpr int CK_THREADS = 512;
constexpr int CK_WARPS = CK_THREADS / 32;

// row padding of a shared tile of T (16-byte rows, banks spread)
template <typename T>
constexpr int pad_of() { return sizeof(T) == 2 ? 8 : 4; }

// dynamic shared memory of ssd_bwd_states_kernel<T, P, N>, byte offsets:
// a two-stage ring of a chunk's B (or C), x (or dy), dt and decay rows;
// the factors; the state (or cotangent)
template <typename T, int P, int N>
struct WalkSmem {
    static constexpr int LDT = N + pad_of<T>();        // B, C rows (T)
    static constexpr int LDX = P + pad_of<T>();        // x rows (T)
    static constexpr int LDY = P + 4;                  // dy rows (fp32)
    static constexpr int LDS = N + 4;                  // state rows
    static constexpr int SZ_X = CH * LDX * sizeof(T), SZ_Y = CH * LDY * 4;
    static constexpr int OFF_X = CH * LDT * sizeof(T);
    static constexpr int OFF_Y = OFF_X;         // x (forward) or dy (reverse)
    static constexpr int OFF_D = OFF_X + (SZ_X > SZ_Y ? SZ_X : SZ_Y);
    static constexpr int STAGE = OFF_D + 2 * CH * 4;            // dt, decay
    static constexpr int OFF_F = 2 * STAGE;                     // CH + 4
    static constexpr int OFF_S = OFF_F + (CH + 4) * 4;
    static constexpr int BYTES = OFF_S + P * LDS * 4;
};

// The walk over the chunks (s >= 64), a block per (direction, head, batch
// row), the whole [p x n] state:
//
//   forward:  S <- A_63 S + (x o T dt)^T B,   storing S before each chunk
//   reverse:  G <- A_63 G + (dy o A)^T C,     storing G after each chunk
//
// (G from dS_T, the chunks in reverse; dS0 = G at the end), with A_i =
// prod_{m<=i} a_m and T_j = prod_{j<m<64} a_m by a scan of products over
// the chunk's decays (a masked step past s has decay 1), the product on
// mma.sync (3xTF32) over the chunk's 64 steps, and the next chunk's tiles
// loading (a two-stage cp.async ring) while this one is computed.  The
// boundaries go to the scratch: S [b, h, chunk, p, n] then G likewise.
template <typename T, int P, int N>
__global__ void __launch_bounds__(WALK_THREADS)
ssd_bwd_states_kernel(Params p) {
    using L = WalkSmem<T, P, N>;
    constexpr int NT = WALK_THREADS;
    constexpr int NB = P * N >= 2048 ? P * N / 1024 : 1;     // 8 jobs
    constexpr bool EX = sizeof(T) == 2;     // bf16 x, B, C: exact in TF32
    constexpr int EPC = 16 / sizeof(T);     // elements per 16-byte copy
    constexpr int LDT = L::LDT, LDX = L::LDX, LDY = L::LDY, LDS = L::LDS;
    extern __shared__ __align__(16) unsigned char smem[];
    float* fac = reinterpret_cast<float*>(smem + L::OFF_F);
    float* st = reinterpret_cast<float*>(smem + L::OFF_S);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const bool rev = blockIdx.x == 1;
    const int h = blockIdx.y, bi = blockIdx.z;
    const int grp = h / (p.h / p.g);
    const int nch = (p.s + CH - 1) / CH;
    const T* X = static_cast<const T*>(p.x) + bi * p.x_sb + h * p.x_sh;
    const float* DY = p.dy + bi * p.y_sb + h * p.y_sh;
    const T* BC = rev
        ? static_cast<const T*>(p.C) + bi * p.C_sb + grp * p.C_sg
        : static_cast<const T*>(p.B) + bi * p.B_sb + grp * p.B_sg;
    const long long bc_ss = rev ? p.C_ss : p.B_ss;
    const float* DT = p.dt + bi * p.dt_sb + h * p.dt_sh;
    const float* DE = p.decay + bi * p.de_sb + h * p.de_sh;
    const long long head = static_cast<long long>(bi) * p.h + h;
    const long long plane = static_cast<long long>(P) * N;
    float* buf = p.ckpt + (rev ? static_cast<long long>(p.b) * p.h * nch
                                     * plane : 0)
                 + head * nch * plane;
    const float* init = (rev ? p.dsT : p.s0) + head * plane;

    // step c of the walk's chunk (forward c, reverse nch - 1 - c): its
    // B (C), the block's x (dy) columns, dt and decay into ring stage sg;
    // rows past s zero-filled
    auto issue = [&](int c, int sg) {
        const int t0 = (rev ? nch - 1 - c : c) * CH;
        const int nv = min(CH, p.s - t0);
        unsigned char* base = smem + sg * L::STAGE;
        T* bc = reinterpret_cast<T*>(base);
        constexpr int BROW = N / EPC;
        for (int e = tid; e < CH * BROW; e += NT) {
            const int t = e / BROW, cc = (e % BROW) * EPC;
            const bool in = t < nv;
            const long long tt = in ? t0 + t : 0;
            sm::cp_async16(bc + t * LDT + cc, BC + tt * bc_ss + cc, in);
        }
        if (rev) {
            float* ys = reinterpret_cast<float*>(base + L::OFF_Y);
            constexpr int YROW = P / 4;
            for (int e = tid; e < CH * YROW; e += NT) {
                const int t = e / YROW, cc = (e % YROW) * 4;
                const bool in = t < nv;
                const long long tt = in ? t0 + t : 0;
                sm::cp_async16(ys + t * LDY + cc, DY + tt * p.y_ss + cc, in);
            }
        } else {
            T* xs = reinterpret_cast<T*>(base + L::OFF_X);
            constexpr int XROW = P / EPC;
            for (int e = tid; e < CH * XROW; e += NT) {
                const int t = e / XROW, cc = (e % XROW) * EPC;
                const bool in = t < nv;
                const long long tt = in ? t0 + t : 0;
                sm::cp_async16(xs + t * LDX + cc, X + tt * p.x_ss + cc, in);
            }
        }
        float* dts = reinterpret_cast<float*>(base + L::OFF_D);
        for (int e = tid; e < 2 * CH; e += NT) {
            const int t = e % CH;
            const bool in = t < nv;
            const long long tt = in ? t0 + t : 0;
            sm::cp_async4(dts + e, e < CH ? DT + tt * p.dt_ss
                                          : DE + tt * p.de_ss, in);
        }
        sm::cp_async_commit();
    };

    for (int e = tid; e < P * N; e += NT)
        st[(e / N) * LDS + e % N] = init[e];
    issue(0, 0);
    for (int c = 0; c < nch; ++c) {
        const int cur = c & 1;
        const int ch = rev ? nch - 1 - c : c;
        const int nv = min(CH, p.s - ch * CH);
        sm::cp_async_wait<0>();
        __syncthreads();        // this chunk's tiles; the last update written
        if (c + 1 < nch) issue(c + 1, cur ^ 1);
        const unsigned char* base = smem + cur * L::STAGE;
        const T* bc = reinterpret_cast<const T*>(base);
        const T* xs = reinterpret_cast<const T*>(base + L::OFF_X);
        const float* ys = reinterpret_cast<const float*>(base + L::OFF_Y);
        const float* dts = reinterpret_cast<const float*>(base + L::OFF_D);
        // the rows at this chunk's boundary: S before it, G after it
        float* dst = buf + static_cast<long long>(ch) * plane;
        for (int e = tid; e < P * N; e += NT)
            dst[e] = st[(e / N) * LDS + e % N];
        // forward: fac_j = T_j dt_j, fac[CH] = A_63; reverse: fac_i = A_i
        const float a = tid < nv ? dts[CH + tid] : 1.f;
        if (rev) {
            const float f = sm::scan_prod64<false>(a, fac + CH + 2);
            if (tid < CH) fac[tid] = f;
        } else {
            // prod_{m>=j} a_m, then T_j = the next one's (1 past the end)
            const float sf = sm::scan_prod64<true>(a, fac + CH + 2);
            if (tid < CH) {
                const float nx = __shfl_down_sync(0xffffffffu, sf, 1);
                const float tj = lane < 31 ? nx : tid < 32 ? fac[CH + 3] : 1.f;
                fac[tid] = tj * dts[tid];
                if (tid == 0) fac[CH] = sf;
            }
        }
        __syncthreads();
        const float total = rev ? fac[CH - 1] : fac[CH];
        sm::warp_jobs<P, N, NB, NT / 32>(warp, [&](int r0, int c0) {
            float acc[NB][4];
            sm::acc_set(acc, r0, c0, [&](int r, int cc) {
                return total * st[r * LDS + cc];
            });
            auto b = [&](int k, int cc) {
                return sm::to_f32(bc[k * LDT + cc]);
            };
            if (rev)
                sm::warp_mma<false, EX, NB>(
                    acc, r0, c0, 0, CH,
                    [&](int r, int k) { return ys[k * LDY + r] * fac[k]; }, b);
            else
                sm::warp_mma<false, EX, NB>(
                    acc, r0, c0, 0, CH,
                    [&](int r, int k) {
                        return sm::to_f32(xs[k * LDX + r]) * fac[k];
                    }, b);
            __syncwarp();
            sm::acc_each(acc, r0, c0, [&](int r, int cc, float v) {
                st[r * LDS + cc] = v;
            });
        });
    }
    __syncthreads();
    if (rev) {
        float* d0 = p.ds0 + head * plane;
        for (int e = tid; e < P * N; e += NT)
            d0[e] = st[(e / N) * LDS + e % N];
    }
}

// dynamic shared memory of ssd_bwd_chunk_kernel<T, P, N>, byte offsets
template <typename T, int P, int N>
struct ChunkSmem {
    static constexpr int LDX = P + pad_of<T>();        // x rows (T)
    static constexpr int LDT = N + pad_of<T>();        // B, C rows (T)
    static constexpr int LDY = P + 4;                  // dy rows (fp32)
    static constexpr int LDS = N + 4;                  // S, G rows
    static constexpr int LDL = CH + 5;                 // L rows
    static constexpr int LDM = CH + 4;                 // M, N, W rows
    static constexpr int OFF_B = CH * LDX * sizeof(T);
    static constexpr int OFF_C = OFF_B + CH * LDT * sizeof(T);
    static constexpr int OFF_Y = OFF_C + CH * LDT * sizeof(T);
    static constexpr int OFF_S = OFF_Y + CH * LDY * 4;
    static constexpr int OFF_G = OFF_S + P * LDS * 4;
    static constexpr int OFF_L = OFF_G + P * LDS * 4;
    static constexpr int OFF_M = OFF_L + CH * LDL * 4;
    static constexpr int OFF_N = OFF_M + CH * LDM * 4;
    static constexpr int OFF_W = OFF_N + CH * LDM * 4;
    // dt, decay, A, T, u, v; [v, ddt, u][column group < 4] partial rows;
    // the warps' parts of <G, S>
    static constexpr int OFF_V = OFF_W + CH * LDM * 4;
    static constexpr int BYTES = OFF_V + (18 * CH + CK_WARPS) * 4;
    static_assert(BYTES <= 232448, "one block's shared memory");
};

// Every chunk's gradients at once (s >= 64), a block per (chunk, head,
// batch row), from S (the state before the chunk) and G (the cotangent
// of the state after it) that ssd_bwd_states_kernel stored.  Steps local
// to the chunk, L_ij = prod_{j<m<=i} a_m (running products along each
// row, as ssd_scores_kernel forms them), A_i = L_i0 a_0, T_j = prod_{j<
// m<64} a_m:
//
//   M = (C B^T) o L,  N = (dy x^T) o L o dt_j,  W = (dy x^T) o (C B^T) o
//   dt_j (j < i)
//   dx_j  = dt_j (T_j G B_j + sum_{i>=j} M_ij dy_i),  ddt_j = x_j . (..)
//   dC    = diag(A) dy S + N B,   dB = diag(T dt) x G + N^T C
//   ddecay_t = A_{t-1} R_t + Z_t + T_t (A_{t-1} <G, S> + F_t)
//
// with u_i = C_i . (S^T dy_i), R_t = sum_{i>=t} L_it u_i, v_j = dt_j x_j
// . G B_j, F_t = sum_{j<t} L_{t-1,j} v_j, and Z_t = sum_{i>=t} L_it
// P_i(t), P_i(t) = sum_{j<t} L_{t-1,j} W_ij: <G_t, S_{t-1}> split into
// terms whose factors are products of the decays on either side of t (no
// quotient of decays).  Every product is on mma.sync (3xTF32; the warps
// share each [64 x 64] output in 16 tiles); P_i(t), a recurrence along
// row i, is a blocked scan over 8 threads a row (each block of 8 steps
// from 0, the carries in by products of the decays between), and R, F, Z
// sums over 8 threads a step, on the CUDA cores.  dB and dC go to the
// per-head fp32 partials, which ssd_bwd_group_kernel adds in head order.
template <typename T, int P, int N>
__global__ void __launch_bounds__(CK_THREADS, 1)
ssd_bwd_chunk_kernel(Params p) {
    using L = ChunkSmem<T, P, N>;
    constexpr int NT = CK_THREADS, NW = CK_WARPS;
    constexpr bool EX = sizeof(T) == 2;     // bf16 x, B, C: exact in TF32
    constexpr int EPC = 16 / sizeof(T);
    constexpr int LDX = L::LDX, LDT = L::LDT, LDY = L::LDY, LDS = L::LDS,
                  LDL = L::LDL, LDM = L::LDM;
    constexpr int NBC = CH / 32;                    // [64 x 64]: 4 x 4 jobs
    constexpr int NBP = P >= 32 ? P / 32 : 1;       // [64 x P]: 4 x GP jobs
    constexpr int NBN = N >= 32 ? N / 32 : 1;
    constexpr int GP = P / (8 * NBP), GN = N / (8 * NBN);
    constexpr int TPR = NT / CH, BL = CH / TPR;     // the tail's threads
    static_assert(NW == 16 && GP <= 4 && GN <= 4 && TPR <= 32, "split");
    extern __shared__ __align__(16) unsigned char smem[];
    T* xs = reinterpret_cast<T*>(smem);
    T* bs = reinterpret_cast<T*>(smem + L::OFF_B);
    T* cs = reinterpret_cast<T*>(smem + L::OFF_C);
    float* ys = reinterpret_cast<float*>(smem + L::OFF_Y);
    float* Ss = reinterpret_cast<float*>(smem + L::OFF_S);
    float* Gs = reinterpret_cast<float*>(smem + L::OFF_G);
    float* Lm = reinterpret_cast<float*>(smem + L::OFF_L);
    float* Mm = reinterpret_cast<float*>(smem + L::OFF_M);
    float* Nm = reinterpret_cast<float*>(smem + L::OFF_N);
    float* Wm = reinterpret_cast<float*>(smem + L::OFF_W);
    float* dts = reinterpret_cast<float*>(smem + L::OFF_V);
    float* as = dts + CH;
    float* Ai = as + CH;
    float* Tj = Ai + CH;
    float* uv = Tj + CH;
    float* vv = uv + CH;
    float* part = vv + CH;          // [v, ddt, u][column group][CH]
    float* gsp = part + 12 * CH;    // [NW]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int ch = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
    const int t0 = ch * CH;
    const int nv = min(CH, p.s - t0);
    const int nch = gridDim.x;
    const int grp = h / (p.h / p.g);
    const T* X = static_cast<const T*>(p.x) + bi * p.x_sb + h * p.x_sh;
    const T* Bp = static_cast<const T*>(p.B) + bi * p.B_sb + grp * p.B_sg;
    const T* Cp = static_cast<const T*>(p.C) + bi * p.C_sb + grp * p.C_sg;
    const float* DY = p.dy + bi * p.y_sb + h * p.y_sh;
    const float* DT = p.dt + bi * p.dt_sb + h * p.dt_sh;
    const float* DE = p.decay + bi * p.de_sb + h * p.de_sh;
    const long long head = static_cast<long long>(bi) * p.h + h;
    const long long plane = static_cast<long long>(P) * N;
    const float* Sb = p.ckpt + (head * nch + ch) * plane;
    const float* Gb = Sb + static_cast<long long>(p.b) * p.h * nch * plane;

    // the chunk's x, B, C, dy (rows past s zero-filled), dt, decay, and S, G
    {
        constexpr int XROW = P / EPC, BROW = N / EPC, YROW = P / 4,
                      SROW = N / 4;
        for (int e = tid; e < CH * XROW; e += NT) {
            const int t = e / XROW, c = (e % XROW) * EPC;
            const bool in = t < nv;
            const long long tt = in ? t0 + t : 0;
            sm::cp_async16(xs + t * LDX + c, X + tt * p.x_ss + c, in);
        }
        for (int e = tid; e < CH * BROW; e += NT) {
            const int t = e / BROW, c = (e % BROW) * EPC;
            const bool in = t < nv;
            const long long tt = in ? t0 + t : 0;
            sm::cp_async16(bs + t * LDT + c, Bp + tt * p.B_ss + c, in);
            sm::cp_async16(cs + t * LDT + c, Cp + tt * p.C_ss + c, in);
        }
        for (int e = tid; e < CH * YROW; e += NT) {
            const int t = e / YROW, c = (e % YROW) * 4;
            const bool in = t < nv;
            const long long tt = in ? t0 + t : 0;
            sm::cp_async16(ys + t * LDY + c, DY + tt * p.y_ss + c, in);
        }
        for (int e = tid; e < P * SROW; e += NT) {
            const int r = e / SROW, c = (e % SROW) * 4;
            sm::cp_async16(Ss + r * LDS + c, Sb + r * N + c, true);
            sm::cp_async16(Gs + r * LDS + c, Gb + r * N + c, true);
        }
        for (int e = tid; e < 2 * CH; e += NT) {
            const int t = e % CH;
            const bool in = t < nv;
            const long long tt = in ? t0 + t : 0;
            sm::cp_async4(dts + e, e < CH ? DT + tt * p.dt_ss
                                          : DE + tt * p.de_ss, in);
        }
        sm::cp_async_commit();
        sm::cp_async_wait<0>();
        __syncthreads();
    }
    auto am = [&](int m) { return m < nv ? as[m] : 1.f; };

    // L by running products along each row, A_i; T_j
    if (tid < CH) {
        const int i = tid;
        float f = 1.f;
        Lm[i * LDL + i] = 1.f;
        for (int j = i - 1; j >= 0; --j) {
            f *= am(j + 1);
            Lm[i * LDL + j] = f;
        }
        Ai[i] = f * am(0);
    } else if (tid < 2 * CH) {
        const int j = tid - CH;
        float f = 1.f;
        for (int m = CH - 1; m > j; --m) f *= am(m);
        Tj[j] = f;
    }
    __syncthreads();

    // C B^T and dy x^T on the tiles with j <= i, then M, N and W
    sm::warp_jobs<CH, CH, NBC, NW>(warp, [&](int r0, int c0) {
        if (c0 > r0 + 15) return;           // above the diagonal
        float cb[NBC][4] = {}, dx[NBC][4] = {};
        sm::warp_mma<EX, EX, NBC>(
            cb, r0, c0, 0, N,
            [&](int i, int k) { return sm::to_f32(cs[i * LDT + k]); },
            [&](int k, int j) { return sm::to_f32(bs[j * LDT + k]); });
        sm::warp_mma<false, EX, NBC>(
            dx, r0, c0, 0, P, [&](int i, int k) { return ys[i * LDY + k]; },
            [&](int k, int j) { return sm::to_f32(xs[j * LDX + k]); });
        const int g = lane >> 2, tq = lane & 3;
#pragma unroll
        for (int nb = 0; nb < NBC; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int i = r0 + g + 8 * (e >> 1);
                const int j = c0 + 8 * nb + 2 * tq + (e & 1);
                const float l = j <= i ? Lm[i * LDL + j] : 0.f;
                Mm[i * LDM + j] = cb[nb][e] * l;
                Nm[i * LDM + j] = dx[nb][e] * l * dts[j];
                Wm[i * LDM + j] = j < i ? dx[nb][e] * cb[nb][e] * dts[j]
                                        : 0.f;
            }
    });
    __syncthreads();

    // dx and ddt (rows j): the bracket T_j G B_j + sum_{i>=j} M_ij dy_i,
    // and v_j = dt_j x_j . G B_j on the way
    T* DX = static_cast<T*>(p.dx) + (static_cast<long long>(bi) * p.s + t0)
            * p.h * P + static_cast<long long>(h) * P;
    const long long o_ss = static_cast<long long>(p.h) * P;
    sm::warp_jobs<CH, P, NBP, NW>(warp, [&](int r0, int c0) {
        const int cg = c0 / (8 * NBP);
        float acc[NBP][4] = {};
        sm::warp_mma<EX, false, NBP>(
            acc, r0, c0, 0, N,
            [&](int j, int k) { return sm::to_f32(bs[j * LDT + k]); },
            [&](int k, int q) { return Gs[q * LDS + k]; });
        auto xf = [&](int j, int q) { return sm::to_f32(xs[j * LDX + q]); };
        sm::row_sums(acc, r0, c0, xf, part + cg * CH);
        sm::acc_each(acc, r0, c0, [&](int j, int, float& x) { x *= Tj[j]; });
        sm::warp_mma<false, false, NBP>(
            acc, r0, c0, r0, CH, [&](int j, int i) { return Mm[i * LDM + j]; },
            [&](int i, int q) { return ys[i * LDY + q]; });
        sm::row_sums(acc, r0, c0, xf, part + (4 + cg) * CH);
        sm::acc_each(acc, r0, c0, [&](int j, int q, float x) {
            if (j < nv) store(DX + j * o_ss + q, dts[j] * x);
        });
    });
    // dC (rows i) = A_i dy_i S + N B, u_i = C_i . dy_i S on the way; dB
    // (rows j) = T_j dt_j x_j G + N^T C: into the head's partials
    float* dCp = p.dC_part + ((static_cast<long long>(bi) * p.s + t0) * p.h
                              + h) * N;
    float* dBp = p.dB_part + ((static_cast<long long>(bi) * p.s + t0) * p.h
                              + h) * N;
    const long long n_ss = static_cast<long long>(p.h) * N;
    sm::warp_jobs<CH, N, NBN, NW>(warp, [&](int r0, int c0) {
        const int cg = c0 / (8 * NBN);
        float acc[NBN][4] = {};
        sm::warp_mma<false, false, NBN>(
            acc, r0, c0, 0, P, [&](int i, int k) { return ys[i * LDY + k]; },
            [&](int k, int n) { return Ss[k * LDS + n]; });
        sm::row_sums(acc, r0, c0, [&](int i, int n) {
            return sm::to_f32(cs[i * LDT + n]);
        }, part + (8 + cg) * CH);
        sm::acc_each(acc, r0, c0, [&](int i, int, float& x) { x *= Ai[i]; });
        sm::warp_mma<false, EX, NBN>(
            acc, r0, c0, 0, r0 + 16,
            [&](int i, int j) { return Nm[i * LDM + j]; },
            [&](int j, int n) { return sm::to_f32(bs[j * LDT + n]); });
        sm::acc_each(acc, r0, c0, [&](int i, int n, float x) {
            if (i < nv) dCp[i * n_ss + n] = x;
        });
        float acc2[NBN][4] = {};
        sm::warp_mma<EX, false, NBN>(
            acc2, r0, c0, 0, P,
            [&](int j, int k) { return sm::to_f32(xs[j * LDX + k]); },
            [&](int k, int n) { return Gs[k * LDS + n]; });
        sm::acc_each(acc2, r0, c0, [&](int j, int, float& x) {
            x *= Tj[j] * dts[j];
        });
        sm::warp_mma<false, EX, NBN>(
            acc2, r0, c0, r0, CH,
            [&](int j, int i) { return Nm[i * LDM + j]; },
            [&](int i, int n) { return sm::to_f32(cs[i * LDT + n]); });
        sm::acc_each(acc2, r0, c0, [&](int j, int n, float x) {
            if (j < nv) dBp[j * n_ss + n] = x;
        });
    });
    __syncthreads();

    // the rows' sums; the warps' parts of <G, S>; P_i(t) along each row i
    // (into W's place as L_it P_i(t)): thread q of row i's TPR takes the
    // steps [q BL, q BL + BL), first from 0, then from its carry
    if (tid < CH) {
        const int j = tid;
        float v = 0.f, d = 0.f, u = 0.f;
        for (int g = 0; g < GP; ++g) {
            v += part[g * CH + j];
            d += part[(4 + g) * CH + j];
        }
        for (int g = 0; g < GN; ++g) u += part[(8 + g) * CH + j];
        vv[j] = dts[j] * v;
        uv[j] = u;
        if (j < nv)
            p.ddt[(static_cast<long long>(bi) * p.s + t0 + j) * p.h + h] = d;
    }
    {
        float acc = 0.f;
        for (int e = tid; e < P * N; e += NT)
            acc = fmaf(Gs[(e / N) * LDS + e % N], Ss[(e / N) * LDS + e % N],
                       acc);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) gsp[warp] = acc;
    }
    {
        const int i = tid / TPR, q = tid % TPR, tb = q * BL;
        float loc = 0.f, dp = 1.f;
#pragma unroll
        for (int m = 0; m < BL; ++m) {
            loc = fmaf(am(tb + m), loc, Wm[i * LDM + tb + m]);
            dp *= am(tb + m);
        }
        // the carry into block q: the blocks before it, by products
        float pr = 0.f;
        const int first = lane - q;
#pragma unroll
        for (int q2 = 0; q2 + 1 < TPR; ++q2) {
            const float e = __shfl_sync(0xffffffffu, loc, first + q2);
            const float dd = __shfl_sync(0xffffffffu, dp, first + q2);
            if (q2 < q) pr = fmaf(dd, pr, e);
        }
#pragma unroll
        for (int m = 0; m < BL; ++m) {
            const int t = tb + m;
            if (t <= i) {
                const float w = Wm[i * LDM + t];
                Wm[i * LDM + t] = Lm[i * LDL + t] * pr;
                pr = fmaf(am(t), pr, w);
            }
        }
    }
    __syncthreads();
    // per step t (TPR threads, their sums added in a fixed order): Z_t the
    // column sum of L o P, R_t = sum_{i>=t} L_it u_i, F_t = sum_{j<t}
    // L_{t-1,j} v_j; ddecay_t from them and <G, S>
    {
        const int t = tid / TPR, q = tid % TPR;
        float z = 0.f, r = 0.f, f = 0.f;
        for (int i = t + q; i < CH; i += TPR) {
            z += Wm[i * LDM + t];
            r = fmaf(Lm[i * LDL + t], uv[i], r);
        }
        for (int j = q; j < t; j += TPR)
            f = fmaf(Lm[(t - 1) * LDL + j], vv[j], f);
#pragma unroll
        for (int off = 1; off < TPR; off <<= 1) {
            z += __shfl_xor_sync(0xffffffffu, z, off);
            r += __shfl_xor_sync(0xffffffffu, r, off);
            f += __shfl_xor_sync(0xffffffffu, f, off);
        }
        if (q == 0 && t < nv) {
            float gs = 0.f;
            for (int w = 0; w < NW; ++w) gs += gsp[w];
            const float ap = t ? Ai[t - 1] : 1.f;
            p.ddecay[(static_cast<long long>(bi) * p.s + t0 + t) * p.h + h] =
                fmaf(ap, r, z) + Tj[t] * fmaf(ap, gs, f);
        }
    }
}

// ---------------------------------------------------------------------------
// launches

enum Variant { STEP = 0, CHUNK = 1 };

template <typename T, int P, int N>
int launch(const Params& p, int variant, cudaStream_t stream) {
    cudaError_t e;
    if (variant == STEP) {
        constexpr int bytes = Smem<P, N>::BYTES;
        e = cudaFuncSetAttribute(ssd_bwd_kernel<T, P, N>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
        if (e != cudaSuccess) return static_cast<int>(e);
        ssd_bwd_kernel<T, P, N><<<dim3(p.h, p.b), Shape<P, N>::NT, bytes,
                                  stream>>>(p);
    } else if (variant == CHUNK) {
        // the boundaries, then every chunk's gradients
        constexpr int wbytes = WalkSmem<T, P, N>::BYTES;
        constexpr int cbytes = ChunkSmem<T, P, N>::BYTES;
        e = cudaFuncSetAttribute(ssd_bwd_states_kernel<T, P, N>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 wbytes);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(
                ssd_bwd_chunk_kernel<T, P, N>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, cbytes);
        if (e != cudaSuccess) return static_cast<int>(e);
        ssd_bwd_states_kernel<T, P, N><<<dim3(2, p.h, p.b), WALK_THREADS,
                                         wbytes, stream>>>(p);
        e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
        ssd_bwd_chunk_kernel<T, P, N><<<dim3((p.s + CH - 1) / CH, p.h, p.b),
                                        CK_THREADS, cbytes, stream>>>(p);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ssd_bwd_group_kernel<T, N><<<dim3(p.s, p.b), 256, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int launch_n(const Params& p, int n, int variant, cudaStream_t stream) {
    switch (n) {
        case 16: return launch<T, P, 16>(p, variant, stream);
        case 32: return launch<T, P, 32>(p, variant, stream);
        case 64: return launch<T, P, 64>(p, variant, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

template <typename T>
int launch_dims(const Params& p, int hp, int n, int variant,
                cudaStream_t stream) {
    switch (hp) {
        case 16: return launch_n<T, 16>(p, n, variant, stream);
        case 32: return launch_n<T, 32>(p, n, variant, stream);
        case 64: return launch_n<T, 64>(p, n, variant, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

template <int P>
long long smem_n(int n) {
    switch (n) {
        case 16: return Smem<P, 16>::BYTES;
        case 32: return Smem<P, 32>::BYTES;
        case 64: return Smem<P, 64>::BYTES;
        default: return -1;
    }
}

template <typename T, int P>
long long chunk_smem_n(int n) {
    switch (n) {
        case 16: return ChunkSmem<T, P, 16>::BYTES;
        case 32: return ChunkSmem<T, P, 32>::BYTES;
        case 64: return ChunkSmem<T, P, 64>::BYTES;
        default: return -1;
    }
}

template <typename T>
long long chunk_smem(int hp, int n) {
    switch (hp) {
        case 16: return chunk_smem_n<T, 16>(n);
        case 32: return chunk_smem_n<T, 32>(n);
        case 64: return chunk_smem_n<T, 64>(n);
        default: return -1;
    }
}

}  // namespace

// The backward of repro_mamba2_scan.  variant: 0 = stepwise
// (ssd_bwd_kernel; ckpt an fp32 scratch of b h ceil(s / 8) p n elements),
// 1 = chunked, s >= 64 (ssd_bwd_states_kernel then ssd_bwd_chunk_kernel;
// ckpt an fp32 scratch of 2 b h ceil(s / 64) p n elements, the chunks'
// boundary states and cotangents; x, B, C, dy and their batch, sequence
// and head/group strides 16-byte aligned); either then
// ssd_bwd_group_kernel.  dtype (of x, B, C, dx, dB, dC): 0 = fp32, 1 =
// bf16; dy is fp32.  Strides are in elements: (batch, seq, head) for x,
// dt, decay and dy, (batch, seq, group) for B and C.  ckpt is 16-byte
// aligned; dB_part, dC_part: fp32 scratch of b s h n each.  Returns a
// cudaError_t (0 on success); the launches are asynchronous on
// ``stream``.
extern "C" int repro_mamba2_scan_bwd(
    int variant, const void* x, const void* dt, const void* decay,
    const void* B, const void* C, const void* s0, const void* dy,
    const void* dsT, void* dx, void* ddt, void* ddecay, void* dB, void* dC,
    void* ds0, void* ckpt, void* dB_part, void* dC_part, int dtype, int hp,
    int n, int b, int s, int h, int g,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh,
    long long de_sb, long long de_ss, long long de_sh,
    long long B_sb, long long B_ss, long long B_sg,
    long long C_sb, long long C_ss, long long C_sg,
    long long y_sb, long long y_ss, long long y_sh, void* stream) {
    Params p;
    p.x = x;
    p.dt = static_cast<const float*>(dt);
    p.decay = static_cast<const float*>(decay);
    p.B = B;
    p.C = C;
    p.s0 = static_cast<const float*>(s0);
    p.dy = static_cast<const float*>(dy);
    p.dsT = static_cast<const float*>(dsT);
    p.dx = dx;
    p.ddt = static_cast<float*>(ddt);
    p.ddecay = static_cast<float*>(ddecay);
    p.dB = dB;
    p.dC = dC;
    p.ds0 = static_cast<float*>(ds0);
    p.ckpt = static_cast<float*>(ckpt);
    p.dB_part = static_cast<float*>(dB_part);
    p.dC_part = static_cast<float*>(dC_part);
    p.b = b;
    p.s = s;
    p.h = h;
    p.g = g;
    p.x_sb = x_sb;
    p.x_ss = x_ss;
    p.x_sh = x_sh;
    p.dt_sb = dt_sb;
    p.dt_ss = dt_ss;
    p.dt_sh = dt_sh;
    p.de_sb = de_sb;
    p.de_ss = de_ss;
    p.de_sh = de_sh;
    p.B_sb = B_sb;
    p.B_ss = B_ss;
    p.B_sg = B_sg;
    p.C_sb = C_sb;
    p.C_ss = C_ss;
    p.C_sg = C_sg;
    p.y_sb = y_sb;
    p.y_ss = y_ss;
    p.y_sh = y_sh;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (b < 1 || s < 1 || h < 1 || g < 1 || h % g ||
        (variant == CHUNK && s < CH))
        return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 0) return launch_dims<float>(p, hp, n, variant, st);
    if (dtype == 1) return launch_dims<__nv_bfloat16>(p, hp, n, variant, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one ssd_bwd_kernel block, in bytes, or -1 for
// sizes it does not take.
extern "C" long long repro_mamba2_scan_bwd_smem_bytes(int hp, int n) {
    switch (hp) {
        case 16: return smem_n<16>(n);
        case 32: return smem_n<32>(n);
        case 64: return smem_n<64>(n);
        default: return -1;
    }
}

// Dynamic shared memory of one ssd_bwd_chunk_kernel block (dtype as
// above), in bytes, or -1 for sizes it does not take.
extern "C" long long repro_mamba2_scan_bwd_chunk_smem_bytes(int dtype, int hp,
                                                            int n) {
    return dtype == 0 ? chunk_smem<float>(hp, n)
                      : chunk_smem<__nv_bfloat16>(hp, n);
}
