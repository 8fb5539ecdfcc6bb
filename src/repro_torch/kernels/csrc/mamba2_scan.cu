// Mamba-2 SSD recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/mamba2_scan.py::mamba2_scan
// (body _ssd_kernel).  It computes what that kernel computes, y and the
// final state S_T from S0, with one scalar decay per head and step:
//
//   S <- decay_t S + (dt_t x_t) B_t^T,    y_t = S C_t
//
// for x [b, s, h, p], dt and decay [b, s, h], B and C [b, s, g, n] (head h
// reads group h / (h_total / g)) and S0 [b, h, p, n], exact at any decay
// in [0, 1].  The Pallas kernel weighs pairs of steps in a chunk by cp_t /
// max(cp_j, 1e-24) of the running decay product, which departs from the
// recurrence once the product leaves fp32's range (zamba2 at random
// initialisation draws decays down to ~1e-5).  No kernel here divides by
// a decay or a product of decays: every factor is a product of decays,
// formed by multiplying them.
//
// Layouts are the model side's, read in place through strides with a
// contiguous last dimension: x, B and C in fp32 or bf16, dt and decay in
// fp32.  The group broadcast of B and C is an index, not a copy.  S0 and
// S_T are contiguous fp32 [b, h, p, n], and S_T may be S0 itself (every
// block reads its rows of S0 before it writes the same rows of S_T, and
// no two blocks share one), so a cache slot is updated in place.  y is
// written contiguous fp32 [b, s, h, p] (the model adds D x to it in fp32).
// Row p of the state evolves on its own, S[p, :] <- decay_t S[p, :] + dt_t
// x_t[p] B_t, and y_t[p] = S[p, :] . C_t, so every kernel gives a block 16
// rows of one (batch row, head): 256 blocks at zamba2-1.2b's b 1, h 64,
// p 64.  The wrapper (kernels/mamba2_scan.py) picks one of three kernels
// by the sequence length s:
//
// * ssd_decode_kernel, s = 1 (each decode step).  The work is reading and
//   writing the 1 MB fp32 state (b 1, 64 heads of 64 x 64); x, B, C, dt
//   and decay are a few KB.  A thread owns one float4 of one state row
//   (n / 4 lanes a row: whole 32-byte sectors), issues that load with its
//   x_p, dt, decay and four B_n and C_n at once, writes S_T where S0 was,
//   and y_p is a shuffle reduction over the row's lanes.  No shared
//   memory, no barrier.
//
// * ssd_kernel, 2 <= s < 64 (the serving paths' short prompts): the
//   recurrence one step after another.  Each row is split over n / 8
//   lanes holding 8 state values each in registers; y_t[p] is a shuffle
//   reduction over them; time runs in tiles of 32 steps staged in shared
//   memory, the next tile's loads in registers during the current one.
//   It is bound by the latency of one step times s.
//
// * ssd_scores_kernel + ssd_chunk_kernel, s >= 64 (a long prompt): the
//   chunked dual form on the tensor cores.  Time runs in chunks of 64
//   steps.  With S the state before the chunk and steps local to it:
//
//     y_i = A_i (C_i . S^T) + sum_{j <= i} L_ij (C_i . B_j) dt_j x_j
//     S  <- A_63 S + sum_j T_j dt_j x_j B_j^T
//
//   L_ij = prod_{j<m<=i} a_m is built by running products along each row
//   of a [64 x 64] matrix (4,096 multiplies), A_i = L_i0 a_0 and T_j =
//   prod_{j<m<64} a_m likewise, so each is <= 1, accurate to <= 64
//   roundings, and 0 only below fp32's range; a masked step past s has
//   decay 1.  Those factors and the scores M = (C B^T) o L o dt depend on
//   the head only, so ssd_scores_kernel forms them first for every chunk
//   at once (a block per chunk, head and batch row) into a scratch
//   record per chunk; ssd_chunk_kernel then walks the chunks in order,
//   a block on 16 state rows p, a chunk's B, C, x and record coming in
//   through a two-stage cp.async ring.  Every product (C B^T, C S^T, M x
//   and the state's x^T B) runs on mma.sync m16n8k8 TF32; every fp32-
//   derived operand is split into two TF32 parts (3xTF32, scan_mma.cuh),
//   which keeps fp32 accuracy, and a bf16 operand is exact in TF32.  Warp
//   w takes query rows 16w..16w+15 (and only the key tiles j <= i), M's
//   rows become the A operand of the product with x through a permuted k
//   axis, and for the state update warp w takes 16 columns n.  What
//   bounds it on an H100: the bytes are 54.0 MB at s = 2048 (0.016 ms,
//   bf16 inputs) plus the records' round trip; the tensor-core work is
//   small; the products' latency and two block barriers a chunk, in
//   sequence over 32 chunks, are what is left.
//
// Every product and sum is fp32 (the tensor-core ones to 3xTF32).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "scan_mma.cuh"

namespace {

constexpr int NPT = 8;    // state columns (n) per thread
constexpr int PB = 16;    // state rows (p) per block
constexpr int TT = 32;    // time steps per staged tile

struct Params {
    const void* x;
    const float* dt;
    const float* decay;
    const void* B;
    const void* C;
    const float* s0;
    float* y;
    float* sT;
    float* scores;      // the chunked kernel's per-chunk records (scratch)
    int b, s, h, g;
    long long x_sb, x_ss, x_sh;
    long long dt_sb, dt_ss, dt_sh;
    long long de_sb, de_ss, de_sh;
    long long B_sb, B_ss, B_sg;
    long long C_sb, C_ss, C_sg;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <int N>
__host__ __device__ constexpr int threads() { return (N / NPT) * PB; }

template <typename T, int P, int N>
__global__ void __launch_bounds__((N / NPT) * PB) ssd_kernel(Params p) {
    constexpr int NG = N / NPT;             // lanes sharing one row
    constexpr int NT = threads<N>();
    constexpr int LBC = TT * N / NT;        // B, C loads per thread per tile
    constexpr int LX = TT * PB / NT;        // x loads per thread per tile
    static_assert(TT * N % NT == 0 && TT * PB % NT == 0, "tile split");
    static_assert(NT % 32 == 0 && 32 % NG == 0 && NT >= TT, "lane groups");
    __shared__ float Bs[TT][N];
    __shared__ float Cs[TT][N];
    __shared__ float xs[TT][PB];
    __shared__ float dts[TT];
    __shared__ float des[TT];

    const int tid = threadIdx.x;
    const int ng = tid % NG;                // columns ng + NG * i
    const int pl = tid / NG;                // row within the block
    const int p0 = blockIdx.x * PB;
    const int row = p0 + pl;
    const int h = blockIdx.y;
    const int bi = blockIdx.z;
    const int grp = h / (p.h / p.g);

    const T* X = static_cast<const T*>(p.x) + bi * p.x_sb + h * p.x_sh;
    const float* DT = p.dt + bi * p.dt_sb + h * p.dt_sh;
    const float* DE = p.decay + bi * p.de_sb + h * p.de_sh;
    const T* Bp = static_cast<const T*>(p.B) + bi * p.B_sb + grp * p.B_sg;
    const T* Cp = static_cast<const T*>(p.C) + bi * p.C_sb + grp * p.C_sg;
    const long long head = (static_cast<long long>(bi) * p.h + h) * P * N;

    float S[NPT];
#pragma unroll
    for (int i = 0; i < NPT; ++i)
        S[i] = p.s0[head + static_cast<long long>(row) * N + ng + NG * i];

    // one tile's loads, held in registers until the tile is staged
    float pb[LBC], pc[LBC], px[LX], pdt, pde;
    auto fetch = [&](int t0) {
#pragma unroll
        for (int n = 0; n < LBC; ++n) {
            const int e = tid + n * NT;
            const int t = t0 + e / N, c = e % N;
            const bool in = t < p.s;
            pb[n] = in ? to_f32(Bp[t * p.B_ss + c]) : 0.f;
            pc[n] = in ? to_f32(Cp[t * p.C_ss + c]) : 0.f;
        }
#pragma unroll
        for (int n = 0; n < LX; ++n) {
            const int e = tid + n * NT;
            const int t = t0 + e / PB, c = e % PB;
            px[n] = t < p.s ? to_f32(X[t * p.x_ss + p0 + c]) : 0.f;
        }
        const int t = t0 + tid;
        const bool in = tid < TT && t < p.s;
        pdt = in ? DT[t * p.dt_ss] : 0.f;
        pde = in ? DE[t * p.de_ss] : 0.f;
    };

    float* Y = p.y + (static_cast<long long>(bi) * p.s * p.h + h) * P + row;
    const long long y_ss = static_cast<long long>(p.h) * P;

    fetch(0);
    for (int t0 = 0; t0 < p.s; t0 += TT) {
        __syncthreads();                    // the previous tile is consumed
#pragma unroll
        for (int n = 0; n < LBC; ++n) {
            const int e = tid + n * NT;
            Bs[e / N][e % N] = pb[n];
            Cs[e / N][e % N] = pc[n];
        }
#pragma unroll
        for (int n = 0; n < LX; ++n) {
            const int e = tid + n * NT;
            xs[e / PB][e % PB] = px[n];
        }
        if (tid < TT) {
            dts[tid] = pdt;
            des[tid] = pde;
        }
        __syncthreads();
        if (t0 + TT < p.s) fetch(t0 + TT);  // in flight during this tile
        const int nt = min(TT, p.s - t0);
        for (int tt = 0; tt < nt; ++tt) {
            const float dtx = dts[tt] * xs[tt][pl];
            const float de = des[tt];
            float acc = 0.f;
#pragma unroll
            for (int i = 0; i < NPT; ++i) {
                const int c = ng + NG * i;
                S[i] = fmaf(de, S[i], dtx * Bs[tt][c]);
                acc = fmaf(S[i], Cs[tt][c], acc);
            }
#pragma unroll
            for (int off = 1; off < NG; off <<= 1)
                acc += __shfl_xor_sync(0xffffffffu, acc, off);
            if (ng == 0) Y[(t0 + tt) * y_ss] = acc;
        }
    }

#pragma unroll
    for (int i = 0; i < NPT; ++i)
        p.sT[head + static_cast<long long>(row) * N + ng + NG * i] = S[i];
}

// ---------------------------------------------------------------------------
// s = 1: the decode kernel, bound by the state's bytes

template <typename T, int P, int N>
__global__ void __launch_bounds__(PB * N / 4) ssd_decode_kernel(Params p) {
    constexpr int LPR = N / 4;              // lanes per state row
    const int tid = threadIdx.x;
    const int q4 = tid % LPR;
    const int row = blockIdx.x * PB + tid / LPR;
    const int h = blockIdx.y;
    const int bi = blockIdx.z;
    const int grp = h / (p.h / p.g);
    const long long head = (static_cast<long long>(bi) * p.h + h) * P * N;
    const long long at = head + static_cast<long long>(row) * N + 4 * q4;

    // every load at once: the state's float4, x_p, dt, decay, B and C
    const float4 s4 = *reinterpret_cast<const float4*>(p.s0 + at);
    const T* X = static_cast<const T*>(p.x) + bi * p.x_sb + h * p.x_sh;
    const T* Bp = static_cast<const T*>(p.B) + bi * p.B_sb + grp * p.B_sg;
    const T* Cp = static_cast<const T*>(p.C) + bi * p.C_sb + grp * p.C_sg;
    const float x = to_f32(X[row]);
    const float dt = p.dt[bi * p.dt_sb + h * p.dt_sh];
    const float de = p.decay[bi * p.de_sb + h * p.de_sh];
    float Bv[4], Cv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        Bv[q] = to_f32(Bp[4 * q4 + q]);
        Cv[q] = to_f32(Cp[4 * q4 + q]);
    }
    const float dtx = dt * x;
    float S[4] = {s4.x, s4.y, s4.z, s4.w}, acc = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        S[q] = fmaf(de, S[q], dtx * Bv[q]);
        acc = fmaf(S[q], Cv[q], acc);
    }
    *reinterpret_cast<float4*>(p.sT + at) = make_float4(S[0], S[1], S[2],
                                                        S[3]);
#pragma unroll
    for (int off = 1; off < LPR; off <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (q4 == 0) p.y[(static_cast<long long>(bi) * p.h + h) * P + row] = acc;
}

// ---------------------------------------------------------------------------
// s >= 64: the chunked form on the tensor cores

namespace sm = scan_mma;

constexpr int CH = 64;        // steps per chunk
constexpr int CK_THREADS = 128;
constexpr int LDM = CH + 8;   // row stride of a chunk's score matrix M
// a chunk's scratch record: M [CH][CH], A_i [CH], T_j dt_j [CH] (fp32)
constexpr int REC = CH * CH + 2 * CH;

template <typename T, int N>
struct Tiles {
    static constexpr int LDT = N + (sizeof(T) == 2 ? 8 : 4);   // B, C rows
    static constexpr int SZ_BC = CH * LDT * sizeof(T);
};

// dynamic shared memory of ssd_scores_kernel<T, N>, byte offsets
template <typename T, int N>
struct ScoresSmem {
    static constexpr int LDL = CH + 5;     // L rows: 5 i + j distinct banks
    static constexpr int OFF_C = Tiles<T, N>::SZ_BC;
    static constexpr int OFF_D = 2 * Tiles<T, N>::SZ_BC;   // dt, then decay
    static constexpr int OFF_L = OFF_D + 2 * CH * 4;
    static constexpr int BYTES = OFF_L + CH * LDL * 4;
};

// dynamic shared memory of ssd_chunk_kernel<T, P, N>, byte offsets: a
// two-stage ring of B, C, x and the chunk's record (M, A, T dt)
template <typename T, int N>
struct ChunkSmem {
    static constexpr int LDT = Tiles<T, N>::LDT;
    static constexpr int LDX = PB + (sizeof(T) == 2 ? 8 : 4);  // x rows
    static constexpr int LDS = N + 4;                          // state rows
    static constexpr int SZ_BC = Tiles<T, N>::SZ_BC;
    static constexpr int SZ_X = CH * LDX * sizeof(T);
    static constexpr int OFF_X = 2 * SZ_BC;
    static constexpr int OFF_M = OFF_X + SZ_X;
    static constexpr int OFF_A = OFF_M + CH * LDM * 4;
    static constexpr int OFF_T = OFF_A + CH * 4;
    static constexpr int STAGE = OFF_T + CH * 4;
    static constexpr int OFF_S = 2 * STAGE;
    static constexpr int BYTES = OFF_S + PB * LDS * 4;
};

// one chunk's B and C rows (all n) into shared memory by 16-byte cp.async,
// rows past s zero-filled (not committed)
template <typename T, int N, int NT>
__device__ __forceinline__ void issue_bc(const Params& p, const T* Bp,
                                         const T* Cp, T* Bs, T* Cs, int t0,
                                         int tid) {
    constexpr int LDT = Tiles<T, N>::LDT;
    constexpr int EPC = 16 / sizeof(T);
    constexpr int BROW = N / EPC;
    for (int e = tid; e < CH * BROW; e += NT) {
        const int t = e / BROW, c = (e % BROW) * EPC;
        const bool in = t0 + t < p.s;
        const long long tt = in ? t0 + t : 0;
        sm::cp_async16(Bs + t * LDT + c, Bp + tt * p.B_ss + c, in);
        sm::cp_async16(Cs + t * LDT + c, Cp + tt * p.C_ss + c, in);
    }
}

// The per-head part of the chunked form, a block per (chunk, head, batch
// row), all chunks at once before ssd_chunk_kernel walks them in order:
// the decay matrix L_ij = prod_{j<m<=i} a_m by running products along
// each row (4,096 multiplies, from the diagonal outwards; a step past s
// has decay 1), A_i = L_i0 a_0, T_j = prod_{j<m<64} a_m (the same
// products as L's last row) times dt_j, and the scores M = (C B^T) o L o
// dt_j on and below the diagonal, C B^T on mma.sync (warp w: rows 16w..,
// key tiles j <= i only; bf16 B and C are exact in TF32), into scores
// [b, h, chunk] records of REC floats.  They depend on the head (and its
// group) only, so one block forms them for the p / 16 row blocks of
// ssd_chunk_kernel.
template <typename T, int N>
__global__ void __launch_bounds__(CK_THREADS) ssd_scores_kernel(Params p) {
    using L = ScoresSmem<T, N>;
    constexpr int NT = CK_THREADS;
    constexpr bool EX = sizeof(T) == 2;
    constexpr int LDT = Tiles<T, N>::LDT, LDL = L::LDL;
    extern __shared__ __align__(16) unsigned char smem[];
    T* Bt = reinterpret_cast<T*>(smem);
    T* Ct = reinterpret_cast<T*>(smem + L::OFF_C);
    float* dt = reinterpret_cast<float*>(smem + L::OFF_D);
    float* a = dt + CH;
    float* Lm = reinterpret_cast<float*>(smem + L::OFF_L);
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, tg = lane & 3;
    const int ch = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
    const int t0 = ch * CH;
    const int grp = h / (p.h / p.g);
    const T* Bp = static_cast<const T*>(p.B) + bi * p.B_sb + grp * p.B_sg;
    const T* Cp = static_cast<const T*>(p.C) + bi * p.C_sb + grp * p.C_sg;
    const float* DT = p.dt + bi * p.dt_sb + h * p.dt_sh;
    const float* DE = p.decay + bi * p.de_sb + h * p.de_sh;
    issue_bc<T, N, NT>(p, Bp, Cp, Bt, Ct, t0, tid);
    for (int e = tid; e < 2 * CH; e += NT) {
        const int t = e % CH;
        const bool in = t0 + t < p.s;
        const long long tt = in ? t0 + t : 0;
        sm::cp_async4(dt + e, e < CH ? DT + tt * p.dt_ss : DE + tt * p.de_ss,
                      in);
    }
    sm::cp_async_commit();
    sm::cp_async_wait<0>();
    __syncthreads();
    const int nv = min(CH, p.s - t0);
    auto am = [&](int m) { return m < nv ? a[m] : 1.f; };
    float* rec = p.scores +
        ((static_cast<long long>(bi) * p.h + h) * gridDim.x + ch) * REC;

    // L rows, A_i; T_j dt_j (each walk in groups of 8 steps, a group's
    // decays loaded before its products; a decay past the walk's end is
    // read as 1)
    if (tid < CH) {
        const int i = tid;
        float f = 1.f;
        Lm[i * LDL + i] = 1.f;
        for (int jb = i - 1; jb >= 0; jb -= 8) {
            float av[8];
#pragma unroll
            for (int q = 0; q < 8; ++q)
                av[q] = jb - q >= 0 ? am(jb - q + 1) : 1.f;
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                f *= av[q];
                if (jb - q >= 0) Lm[i * LDL + jb - q] = f;
            }
        }
        rec[CH * CH + i] = f * am(0);
    } else {
        const int j = tid - CH;
        float f = 1.f;
        for (int mb = CH - 1; mb > j; mb -= 8) {
            float av[8];
#pragma unroll
            for (int q = 0; q < 8; ++q) av[q] = mb - q > j ? am(mb - q) : 1.f;
#pragma unroll
            for (int q = 0; q < 8; ++q) f *= av[q];
        }
        rec[CH * CH + CH + j] = f * dt[j];
    }
    __syncthreads();

    // G = C B^T on the key tiles j <= i, then M = G o L o dt_j
    const int i0 = 16 * warp;
    const int njt = 2 * warp + 2;
    float G[8][4];
#pragma unroll
    for (int jt = 0; jt < 8; ++jt)
#pragma unroll
        for (int e = 0; e < 4; ++e) G[jt][e] = 0.f;
#pragma unroll
    for (int k8 = 0; k8 < N / 8; ++k8) {
        const int kc = 8 * k8 + tg;
        const float av[4] = {to_f32(Ct[(i0 + g) * LDT + kc]),
                             to_f32(Ct[(i0 + g + 8) * LDT + kc]),
                             to_f32(Ct[(i0 + g) * LDT + kc + 4]),
                             to_f32(Ct[(i0 + g + 8) * LDT + kc + 4])};
        sm::Frag<4> fa;
        sm::split<EX>(fa, av);
#pragma unroll
        for (int jt = 0; jt < 8; ++jt) {
            if (jt < njt) {
                const float bv[2] = {to_f32(Bt[(8 * jt + g) * LDT + kc]),
                                     to_f32(Bt[(8 * jt + g) * LDT + kc + 4])};
                sm::Frag<2> fb;
                sm::split<EX>(fb, bv);
                sm::mma3<EX, EX>(G[jt], fa, fb);
            }
        }
    }
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
        if (jt < njt) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int i = i0 + g + 8 * half;
                const int j = 8 * jt + 2 * tg;
                float m2[2];
#pragma unroll
                for (int q = 0; q < 2; ++q)
                    m2[q] = j + q <= i ? G[jt][2 * half + q] *
                        Lm[i * LDL + j + q] * dt[j + q] : 0.f;
                *reinterpret_cast<float2*>(rec + i * CH + j) =
                    make_float2(m2[0], m2[1]);
            }
        }
    }
}

// The walk over the chunks in order: a block owns 16 state rows p of one
// head, a chunk's B, C, x and the scores record come in through a
// two-stage cp.async ring, and every product is on mma.sync (3xTF32):
//
//   y = diag(A) (C S^T) + M x,    S <- A_63 S + (x o T dt)^T B
//
// warp w taking query rows 16w..16w+15 (and only the key tiles j <= i of
// M) and, for the state, the columns n of tiles w, w + 4.
template <typename T, int P, int N>
__global__ void __launch_bounds__(CK_THREADS) ssd_chunk_kernel(Params p) {
    using L = ChunkSmem<T, N>;
    constexpr int NT = CK_THREADS;
    constexpr bool EX = sizeof(T) == 2;     // bf16 x, B, C: exact in TF32
    constexpr int EPC = 16 / sizeof(T);     // elements per 16-byte copy
    constexpr int LDT = L::LDT, LDX = L::LDX, LDS = L::LDS;
    extern __shared__ __align__(16) unsigned char smem[];
    auto stage = [&](int st) { return smem + st * L::STAGE; };
    float* Ss = reinterpret_cast<float*>(smem + L::OFF_S);

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, tg = lane & 3;
    const int p0 = blockIdx.x * PB;
    const int h = blockIdx.y;
    const int bi = blockIdx.z;
    const int grp = h / (p.h / p.g);
    const T* X = static_cast<const T*>(p.x) + bi * p.x_sb + h * p.x_sh + p0;
    const T* Bp = static_cast<const T*>(p.B) + bi * p.B_sb + grp * p.B_sg;
    const T* Cp = static_cast<const T*>(p.C) + bi * p.C_sb + grp * p.C_sg;
    const long long head = (static_cast<long long>(bi) * p.h + h) * P * N;
    const int nch = (p.s + CH - 1) / CH;
    const float* Rec = p.scores +
        (static_cast<long long>(bi) * p.h + h) * nch * REC;

    // one chunk's B, C (all n), x (the block's rows) and scores record
    // into ring stage st; rows past s are zero-filled
    auto issue = [&](int ch, int st) {
        const int t0 = ch * CH;
        unsigned char* b = stage(st);
        issue_bc<T, N, NT>(p, Bp, Cp, reinterpret_cast<T*>(b),
                           reinterpret_cast<T*>(b + L::SZ_BC), t0, tid);
        T* xs = reinterpret_cast<T*>(b + L::OFF_X);
        constexpr int XROW = PB / EPC;
        for (int e = tid; e < CH * XROW; e += NT) {
            const int t = e / XROW, c = (e % XROW) * EPC;
            const bool in = t0 + t < p.s;
            const long long tt = in ? t0 + t : 0;
            sm::cp_async16(xs + t * LDX + c, X + tt * p.x_ss + c, in);
        }
        // M by rows of CH floats (into rows of LDM), then A and T dt
        const float* rec = Rec + static_cast<long long>(ch) * REC;
        float* ms = reinterpret_cast<float*>(b + L::OFF_M);
        for (int e = tid; e < CH * CH / 4; e += NT) {
            const int r = e / (CH / 4), c = 4 * (e % (CH / 4));
            sm::cp_async16(ms + r * LDM + c, rec + r * CH + c, true);
        }
        for (int e = tid; e < 2 * CH / 4; e += NT)
            sm::cp_async16(reinterpret_cast<float*>(b + L::OFF_A) + 4 * e,
                           rec + CH * CH + 4 * e, true);
        sm::cp_async_commit();
    };

    for (int e = tid; e < PB * N; e += NT)
        Ss[(e / N) * LDS + e % N] =
            p.s0[head + static_cast<long long>(p0) * N + e];
    issue(0, 0);

    float* Y = p.y + (static_cast<long long>(bi) * p.s * p.h + h) * P + p0;
    const long long y_ss = static_cast<long long>(p.h) * P;
    const int i0 = 16 * warp;               // the warp's query rows
    const int njt = 2 * warp + 2;           // key tiles of 8 with j <= i

    for (int ch = 0; ch < nch; ++ch) {
        const int cur = ch & 1;
        sm::cp_async_wait<0>();
        __syncthreads();        // this chunk's tiles; the last state written
        if (ch + 1 < nch) issue(ch + 1, cur ^ 1);
        const int nv = min(CH, p.s - ch * CH);
        const unsigned char* b = stage(cur);
        const T* Bt = reinterpret_cast<const T*>(b);
        const T* Ct = reinterpret_cast<const T*>(b + L::SZ_BC);
        const T* xt = reinterpret_cast<const T*>(b + L::OFF_X);
        const float* Mt = reinterpret_cast<const float*>(b + L::OFF_M);
        const float* Ai = reinterpret_cast<const float*>(b + L::OFF_A);
        const float* Tdt = reinterpret_cast<const float*>(b + L::OFF_T);

        // the inter term C S^T, scaled by A_i (two accumulators a tile,
        // even and odd k steps, so that two mma chains run at once)
        float Yc[2][2][4];
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int pt = 0; pt < 2; ++pt)
#pragma unroll
                for (int e = 0; e < 4; ++e) Yc[q][pt][e] = 0.f;
#pragma unroll
        for (int k8 = 0; k8 < N / 8; ++k8) {
            const int kc = 8 * k8 + tg;
            const float av[4] = {to_f32(Ct[(i0 + g) * LDT + kc]),
                                 to_f32(Ct[(i0 + g + 8) * LDT + kc]),
                                 to_f32(Ct[(i0 + g) * LDT + kc + 4]),
                                 to_f32(Ct[(i0 + g + 8) * LDT + kc + 4])};
            sm::Frag<4> fa;
            sm::split<EX>(fa, av);
#pragma unroll
            for (int pt = 0; pt < 2; ++pt) {
                const float bv[2] = {Ss[(8 * pt + g) * LDS + kc],
                                     Ss[(8 * pt + g) * LDS + kc + 4]};
                sm::Frag<2> fb;
                sm::split<false>(fb, bv);
                sm::mma3<EX, false>(Yc[k8 & 1][pt], fa, fb);
            }
        }
        {
            const float A0 = Ai[i0 + g], A1 = Ai[i0 + g + 8];
#pragma unroll
            for (int pt = 0; pt < 2; ++pt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    Yc[0][pt][e] = (Yc[0][pt][e] + Yc[1][pt][e]) *
                                   (e < 2 ? A0 : A1);
                    Yc[1][pt][e] = 0.f;
                }
        }
        // y += M x, M's rows as the A operand with the k axis permuted
        // (slot t takes column 2t, slot t + 4 column 2t + 1)
#pragma unroll
        for (int jt = 0; jt < 8; ++jt) {
            if (jt < njt) {
                const int j0 = 8 * jt + 2 * tg;
                const float2 m0 =
                    *reinterpret_cast<const float2*>(Mt + (i0 + g) * LDM + j0);
                const float2 m1 = *reinterpret_cast<const float2*>(
                    Mt + (i0 + g + 8) * LDM + j0);
                const float av[4] = {m0.x, m1.x, m0.y, m1.y};
                sm::Frag<4> fa;
                sm::split<false>(fa, av);
#pragma unroll
                for (int pt = 0; pt < 2; ++pt) {
                    const int pc = 8 * pt + g;
                    const float bv[2] = {to_f32(xt[j0 * LDX + pc]),
                                         to_f32(xt[(j0 + 1) * LDX + pc])};
                    sm::Frag<2> fb;
                    sm::split<EX>(fb, bv);
                    sm::mma3<false, EX>(Yc[jt & 1][pt], fa, fb);
                }
            }
        }
#pragma unroll
        for (int pt = 0; pt < 2; ++pt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int i = i0 + g + 8 * half;
                if (i < nv)
                    *reinterpret_cast<float2*>(
                        Y + static_cast<long long>(ch * CH + i) * y_ss +
                        8 * pt + 2 * tg) =
                        make_float2(Yc[0][pt][2 * half] + Yc[1][pt][2 * half],
                                    Yc[0][pt][2 * half + 1] +
                                        Yc[1][pt][2 * half + 1]);
            }
        __syncthreads();        // every read of this chunk's S is done

        // S <- A_63 S + (x o T dt)^T B, warp w on columns n of tiles w,
        // w + 4, ...: the tiles' products and their even and odd k steps
        // in separate accumulators (independent mma chains)
        const float atot = Ai[CH - 1];
        constexpr int NTW = (N / 8 + 3) / 4;    // n tiles a warp
        float acc[NTW][2][4];
#pragma unroll
        for (int q = 0; q < NTW; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int n = 8 * (warp + 4 * q) + 2 * tg + (e & 1);
                acc[q][0][e] = warp + 4 * q < N / 8
                    ? atot * Ss[(g + 8 * (e >> 1)) * LDS + n] : 0.f;
                acc[q][1][e] = 0.f;
            }
#pragma unroll
        for (int k8 = 0; k8 < CH / 8; ++k8) {
            const int j = 8 * k8 + tg;
            const float av[4] = {to_f32(xt[j * LDX + g]) * Tdt[j],
                                 to_f32(xt[j * LDX + g + 8]) * Tdt[j],
                                 to_f32(xt[(j + 4) * LDX + g]) * Tdt[j + 4],
                                 to_f32(xt[(j + 4) * LDX + g + 8]) *
                                     Tdt[j + 4]};
            sm::Frag<4> fa;
            sm::split<false>(fa, av);
#pragma unroll
            for (int q = 0; q < NTW; ++q) {
                const int nt = warp + 4 * q;
                if (nt < N / 8) {
                    const float bv[2] = {
                        to_f32(Bt[j * LDT + 8 * nt + g]),
                        to_f32(Bt[(j + 4) * LDT + 8 * nt + g])};
                    sm::Frag<2> fb;
                    sm::split<EX>(fb, bv);
                    sm::mma3<false, EX>(acc[q][k8 & 1], fa, fb);
                }
            }
        }
#pragma unroll
        for (int q = 0; q < NTW; ++q) {
            const int nt = warp + 4 * q;
            if (nt < N / 8) {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    Ss[(g + 8 * (e >> 1)) * LDS + 8 * nt + 2 * tg + (e & 1)] =
                        acc[q][0][e] + acc[q][1][e];
            }
        }
    }
    __syncthreads();
    for (int e = tid; e < PB * N; e += NT)
        p.sT[head + static_cast<long long>(p0) * N + e] =
            Ss[(e / N) * LDS + e % N];
}

// ---------------------------------------------------------------------------
// launches

enum Variant { STEP = 0, DECODE = 1, CHUNK = 2 };

template <typename T, int P, int N>
int launch(const Params& p, int variant, cudaStream_t stream) {
    const dim3 grid(P / PB, p.h, p.b);
    if (variant == STEP) {
        ssd_kernel<T, P, N><<<grid, threads<N>(), 0, stream>>>(p);
    } else if (variant == DECODE) {
        if (p.s != 1) return static_cast<int>(cudaErrorInvalidValue);
        ssd_decode_kernel<T, P, N><<<grid, PB * N / 4, 0, stream>>>(p);
    } else if (variant == CHUNK) {
        // the scores of every chunk, then the walk over chunks
        constexpr int sbytes = ScoresSmem<T, N>::BYTES;
        constexpr int bytes = ChunkSmem<T, N>::BYTES;
        cudaError_t e = cudaFuncSetAttribute(
            ssd_scores_kernel<T, N>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, sbytes);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(
                ssd_chunk_kernel<T, P, N>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e != cudaSuccess) return static_cast<int>(e);
        const dim3 sgrid((p.s + CH - 1) / CH, p.h, p.b);
        ssd_scores_kernel<T, N><<<sgrid, CK_THREADS, sbytes, stream>>>(p);
        e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
        ssd_chunk_kernel<T, P, N><<<grid, CK_THREADS, bytes, stream>>>(p);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
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

template <typename T>
long long chunk_bytes(int n, int which) {
    switch (n) {
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

// variant: 0 = stepwise (ssd_kernel), 1 = decode (ssd_decode_kernel, s
// must be 1; S0 and S_T 16-byte aligned), 2 = chunked (ssd_scores_kernel
// then ssd_chunk_kernel; x, B, C and their batch, sequence and head/group
// strides 16-byte aligned; scores a 16-byte aligned fp32 scratch of b h
// ceil(s / 64) (64 64 + 128) elements, unused by the other variants).
// dtype (of x, B and C): 0 = fp32, 1 = bf16.  hp is the head dimension p,
// n the state size.  Strides are in elements: (batch, seq, head) for x,
// dt and decay, (batch, seq, group) for B and C.  Returns a cudaError_t
// (0 on success); the launches are asynchronous on ``stream``.
extern "C" int repro_mamba2_scan(
    int variant, const void* x, const void* dt, const void* decay,
    const void* B, const void* C, const void* s0, void* y, void* sT,
    void* scores, int dtype, int hp, int n, int b, int s, int h, int g,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh,
    long long de_sb, long long de_ss, long long de_sh,
    long long B_sb, long long B_ss, long long B_sg,
    long long C_sb, long long C_ss, long long C_sg, void* stream) {
    Params p;
    p.x = x;
    p.dt = static_cast<const float*>(dt);
    p.decay = static_cast<const float*>(decay);
    p.B = B;
    p.C = C;
    p.s0 = static_cast<const float*>(s0);
    p.y = static_cast<float*>(y);
    p.sT = static_cast<float*>(sT);
    p.scores = static_cast<float*>(scores);
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
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch_dims<float>(p, hp, n, variant, st);
    if (dtype == 1) return launch_dims<__nv_bfloat16>(p, hp, n, variant, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory per block of the chunked kernel (which = 0) or of
// the scores kernel (which = 1), in bytes (dtype as above), or -1 for a
// state size they do not take.
extern "C" long long repro_mamba2_scan_chunk_smem_bytes(int dtype, int n,
                                                        int which) {
    return dtype == 0 ? chunk_bytes<float>(n, which)
                      : chunk_bytes<__nv_bfloat16>(n, which);
}
