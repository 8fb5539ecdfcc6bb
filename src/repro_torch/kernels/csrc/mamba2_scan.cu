// Mamba-2 SSD recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/mamba2_scan.py::mamba2_scan
// (body _ssd_kernel).  It computes what that kernel computes, y and the
// final state S_T from S0, with one scalar decay per head and step:
//
//   S <- decay_t S + (dt_t x_t) B_t^T,    y_t = S C_t
//
// for x [b, s, h, p], dt and decay [b, s, h], B and C [b, s, g, n] (head h
// reads group h / (h_total / g)) and S0 [b, h, p, n], but as the recurrence
// itself, one step after another.  The Pallas kernel weighs pairs of steps
// in a chunk by cp_t / max(cp_j, 1e-24) of the running decay product, which
// departs from the recurrence once the product leaves fp32's range (zamba2
// at random initialisation draws decays down to ~1e-5); nothing is divided
// out here, so the result is exact at any decay in (0, 1].
//
// Layouts are the model side's, read in place through strides with a
// contiguous last dimension: x, B and C in fp32 or bf16, dt and decay in
// fp32.  The group broadcast of B and C is an index, not a copy.  S0 and
// S_T are contiguous fp32 [b, h, p, n], and S_T may be S0 itself (each
// thread reads its entries of S0 before the time loop and writes the same
// entries after it, and no two threads share one), so a cache slot is
// updated in place.  y is written contiguous fp32
// [b, s, h, p] (the model adds D x to it in fp32).  Any s >= 1 is taken,
// so one kernel serves prefill and the one-token decode step.
//
// Design (simple first): the roles of rwkv6_scan.cu with rows and columns
// swapped.  Row p of the state evolves on its own, S[p, :] <- decay_t
// S[p, :] + dt_t x_t[p] B_t, and y_t[p] = S[p, :] . C_t.  A block owns 16
// rows of one (batch row, head), so p = 64 spreads over 4 blocks (256
// blocks at zamba2-1.2b's b 1, h 64).  Each row is split over n / 8 lanes
// of a warp, each holding 8 of its n state values in registers; y_t[p] is
// a shuffle reduction over those lanes.  Time runs in tiles of 32 steps
// staged in shared memory (B, C broadcast to the block; x for its rows;
// dt and decay), the next tile's loads issued into registers before the
// current tile is computed.
//
// What bounds it on an H100: per token and head it reads p + 2n + 2 values,
// does ~4 p n fp32 operations and writes p values: far below the card's
// balance point, and the sequential steps make it latency-bound at small
// b h.  What this design leaves: the chunked dual form on the tensor cores
// with log-space renormalisation, and TMA tile loads.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

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

template <typename T, int P, int N>
int launch(const Params& p, cudaStream_t stream) {
    const dim3 grid(P / PB, p.h, p.b);
    ssd_kernel<T, P, N><<<grid, threads<N>(), 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int launch_n(const Params& p, int n, cudaStream_t stream) {
    switch (n) {
        case 16: return launch<T, P, 16>(p, stream);
        case 32: return launch<T, P, 32>(p, stream);
        case 64: return launch<T, P, 64>(p, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

template <typename T>
int launch_dims(const Params& p, int hp, int n, cudaStream_t stream) {
    switch (hp) {
        case 16: return launch_n<T, 16>(p, n, stream);
        case 32: return launch_n<T, 32>(p, n, stream);
        case 64: return launch_n<T, 64>(p, n, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// dtype (of x, B and C): 0 = fp32, 1 = bf16.  hp is the head dimension p,
// n the state size.  Strides are in elements: (batch, seq, head) for x,
// dt and decay, (batch, seq, group) for B and C.  Returns a cudaError_t
// (0 on success); the launch is asynchronous on ``stream``.
extern "C" int repro_mamba2_scan(
    const void* x, const void* dt, const void* decay, const void* B,
    const void* C, const void* s0, void* y, void* sT,
    int dtype, int hp, int n, int b, int s, int h, int g,
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
    if (dtype == 0) return launch_dims<float>(p, hp, n, st);
    if (dtype == 1) return launch_dims<__nv_bfloat16>(p, hp, n, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
