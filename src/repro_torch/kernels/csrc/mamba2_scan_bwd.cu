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
// and dB, dC of a B/C group are the sums over its heads.
//
// Every state entry (p, n) evolves on its own, forward (S_pn <- decay
// S_pn + dt x_p B_n) and backward; only the sums cross entries: G B_t
// over a row's n (dx, and through it ddt), dB and dC over a column's p,
// ddecay over all, then dB and dC over the group's heads (all 64 at
// zamba2's one group).  One block owns one (batch row, head): 64 x 64
// entries on 512 threads, each thread one p row and 8 neighbouring n
// columns.  Row sums are shuffles over the row's 8 lanes; column sums
// shuffle over the 4 rows of a warp and meet in shared memory, where the
// warps' partials are added in warp order after each tile; the per-step
// scalars (ddt, ddecay) add the rows in order.  Each head's dB and dC
// go to an fp32 partial [b, s, h, n], which ssd_bwd_group_kernel adds
// over the group's heads in head order.  No float atomics: the result is
// the same bits on every run.
//
// S_{t-1} is never rebuilt by dividing by decay_t (which may be 0).  The
// kernel walks forward from S0 once and stores the state at the start
// of every tile of TS = 8 steps into a scratch (b h ceil(s / 8) p n
// fp32); walking the tiles in reverse it reloads a tile's first state,
// recomputes the tile's 8 states into registers and takes the 8 backward
// steps from them.  A tile's inputs are staged in shared memory, the
// next tile's loads in flight (in registers) while this one is computed.
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
// 64 heads, p 64, n 64) the arithmetic is ~15 fp32 operations per state
// entry and step (16 GFLOP, 0.24 ms at 67 TFLOP/s) against ~0.2 GB of
// inputs and outputs, so the fp32 pipes bound it; the shuffles of the
// column sums and the sequential walk (two passes, one block per head)
// are what this simple design adds on top.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

template <typename T, int P, int N>
int launch(const Params& p, cudaStream_t stream) {
    constexpr int bytes = Smem<P, N>::BYTES;
    cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    ssd_bwd_kernel<T, P, N><<<dim3(p.h, p.b), Shape<P, N>::NT, bytes,
                              stream>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ssd_bwd_group_kernel<T, N><<<dim3(p.s, p.b), 256, 0, stream>>>(p);
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

template <int P>
long long smem_n(int n) {
    switch (n) {
        case 16: return Smem<P, 16>::BYTES;
        case 32: return Smem<P, 32>::BYTES;
        case 64: return Smem<P, 64>::BYTES;
        default: return -1;
    }
}

}  // namespace

// The backward of repro_mamba2_scan.  dtype (of x, B, C, dx, dB, dC):
// 0 = fp32, 1 = bf16; dy is fp32.  Strides are in elements: (batch,
// seq, head) for x, dt, decay and dy, (batch, seq, group) for B and C.  ckpt: a 16-byte aligned fp32 scratch of
// b h ceil(s / 8) p n elements; dB_part, dC_part: fp32 scratch of
// b s h n each.  Returns a cudaError_t (0 on success); the two launches
// (the walk, then the groups' sums over their heads) are asynchronous
// on ``stream``.
extern "C" int repro_mamba2_scan_bwd(
    const void* x, const void* dt, const void* decay, const void* B,
    const void* C, const void* s0, const void* dy, const void* dsT,
    void* dx, void* ddt, void* ddecay, void* dB, void* dC, void* ds0,
    void* ckpt, void* dB_part, void* dC_part, int dtype, int hp, int n,
    int b, int s, int h, int g,
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
    if (b < 1 || s < 1 || h < 1 || g < 1 || h % g)
        return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 0) return launch_dims<float>(p, hp, n, st);
    if (dtype == 1) return launch_dims<__nv_bfloat16>(p, hp, n, st);
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
