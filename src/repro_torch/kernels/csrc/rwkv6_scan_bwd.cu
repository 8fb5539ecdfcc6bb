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
// Every state entry (i, j) evolves on its own, forward (S_ij <- w_i S_ij
// + k_i v_j) and backward (G_ij <- w_i G_ij + r_i dy_j); only the sums
// cross entries: dr, dk and dw over a key row's value columns, dv over a
// value column's key rows, du over b and t.  So one block owns one
// (batch row, head): 64 x 64 entries on 512 threads, each thread one key
// row and 8 neighbouring value columns.  Row sums are shuffles over the
// row's 8 lanes; column sums shuffle over the 4 rows of a warp and meet
// in shared memory, where the 16 warps' partials are added in warp order
// after each tile.  du sums in a register per row, over t in reverse,
// then wkv_bwd_du_kernel adds the batch rows' partials in order.  No
// float atomics: the result is the same bits on every run.
//
// S_{t-1} is never rebuilt by dividing by w_t (which may be 0).  The
// kernel walks forward from S0 once and stores the state at the start
// of every tile of TS = 8 steps into a scratch (b h ceil(s / 8) hd^2
// fp32, 512 MB at b 8, s 512, 64 heads of 64, against 4.3 GB for every
// state); walking the tiles in reverse it reloads a tile's first state,
// recomputes the tile's 8 states into registers and takes the 8 backward
// steps from them.  A tile's inputs are staged in shared memory, the
// next tile's loads in flight (in registers) while this one is computed.
//
// Layouts: r, k, v (fp32 or bf16), w (fp32) and dy (r's type) are the
// model side's [b, s, h, hd], read through strides with a contiguous last
// dimension; u [h, hd], S0 and dS_T [b, h, hd, hd] contiguous fp32.  dr,
// dk, dv are written contiguous [b, s, h, hd] in r's type, dw contiguous
// fp32 [b, s, h, hd], du [h, hd] and dS0 [b, h, hd, hd] fp32.  Every
// product and sum is fp32.
//
// What bounds it on an H100: at b 8, s 512, 64 heads of 64 the arithmetic
// is ~13 fp32 operations per state entry and step (14 GFLOP, 0.21 ms at
// 67 TFLOP/s) against ~0.4 GB of inputs and outputs (0.12 ms), so the
// fp32 pipes bound it; the shuffles of the sums and the sequential walk
// over t (two passes, one block per head) are what this simple design
// adds on top.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
    float* du_part;     // scratch: b h hd
    int b, s, h;
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
    if (cg == 0) p.du_part[head * HD + i] = du_acc;
}

// du[h, i] = the batch rows' partials, added in order
template <int HD>
__global__ void __launch_bounds__(HD) wkv_bwd_du_kernel(Params p) {
    const int i = threadIdx.x, hh = blockIdx.x;
    float acc = 0.f;
    for (int bi = 0; bi < p.b; ++bi)
        acc += p.du_part[(static_cast<long long>(bi) * p.h + hh) * HD + i];
    p.du[hh * HD + i] = acc;
}

template <typename T, int HD>
int launch(const Params& p, cudaStream_t stream) {
    constexpr int bytes = Smem<HD>::BYTES;
    cudaError_t e = cudaFuncSetAttribute(
        wkv_bwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    wkv_bwd_kernel<T, HD><<<dim3(p.h, p.b), Shape<HD>::NT, bytes, stream>>>(
        p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    wkv_bwd_du_kernel<HD><<<p.h, HD, 0, stream>>>(p);
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

// The backward of repro_rwkv6_scan.  dtype (of r, k, v, dy, dr, dk, dv):
// 0 = fp32, 1 = bf16.  Strides are in elements, (batch, seq, head) for
// each of r, k, v, w, dy.  ckpt: a 16-byte aligned fp32 scratch of
// b h ceil(s / 8) hd hd elements; du_part: fp32 scratch of b h hd.
// Returns a cudaError_t (0 on success); the two launches (the walk, then
// du's sum over the batch rows) are asynchronous on ``stream``.
extern "C" int repro_rwkv6_scan_bwd(
    const void* r, const void* k, const void* v, const void* w,
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
    if (b < 1 || s < 1 || h < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 0) return launch_dim<float>(p, hd, st);
    if (dtype == 1) return launch_dim<__nv_bfloat16>(p, hd, st);
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
