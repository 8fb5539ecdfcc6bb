// Flash attention backward for Hopper (sm_90a), plain C interface: two
// kernels, one for dq and one for dk/dv.
//
// Replaces the Pallas TPU kernels of repro/kernels/flash_attention.py::
// flash_bwd (:219): _dq_kernel (:136, here repro_flash_bwd_dq) and
// _dkv_kernel (:177, here repro_flash_bwd_dkv).  Both recompute the
// probabilities from the forward's fp32 log-sum-exp and take
// dl = rowsum(o * do), computed in fp32 by the caller as the JAX package
// computes it outside its kernels:
//
//     p  = exp(q.k * scale - lse)        (0 where masked)
//     ds = p * (do.v - dl) * scale
//     dq = sum_keys ds k
//     dk = sum_{G query heads, queries} ds q
//     dv = sum_{G query heads, queries} p do
//
// Layouts are the model side's, read in place through strides, as in
// flash_fwd.cu: q and do [b, sq, H, d], k and v [b, sk, KV, d] (last dim
// contiguous); lse and dl contiguous [b, H, sq] fp32.  dq is written
// contiguous [b, sq, H, d] in q's type, dk and dv contiguous [b, sk, KV, d]
// in k's type.  Query head h reads KV head h / G (G = H / KV), query row i
// sits at position q_offset + i, keys at positions >= kv_len are masked
// and causal masks kpos > qpos.  Two differences from the Pallas kernels:
//
//   * no GQA folding: the Pallas kernel folds the G query heads of a group
//     into its sequence axis, so its dk/dv grid sums the group for free;
//     here each dk/dv block loops over the G query heads itself and sums
//     them in registers (no atomics, so the result is deterministic);
//   * positions: the Pallas kernels recover causal positions as row % sq,
//     valid only when sq == sk; these use q_offset + i as the forward does.
//
// Inputs are fp32 or bf16; every product and sum is fp32.
//
// Design (simple first), both kernels 256 threads as a 16 x 16 grid:
//   dq:   one block per (64 query rows, query head, batch row) walks the key
//         tiles of 64 (stopping at the last key its rows can see when
//         causal).  Q, dO, K and V tiles are staged in shared memory as
//         fp32; thread (ty, tx) forms s and do.v for rows 4ty..4ty+3 and
//         keys tx + 16j, writes ds to shared memory, then accumulates the
//         dq columns tx + 16c of its rows in registers.
//   dkv:  one block per (64 keys, KV head, batch row) keeps K and V in
//         shared memory and dk, dv for its keys in registers, and walks the
//         G query heads of its group and their query tiles (from the first
//         tile that can see its keys when causal); per tile it forms p and
//         ds transposed (keys 4ty..4ty+3 by queries tx + 16j) into shared
//         memory and accumulates dv += p^T do and dk += ds^T q.
//
// What bounds it on an H100: at the training shape (bf16, sq = sk = 512,
// d 128) the least time for dq is set by its bytes (q, do, dq and k, v
// over HBM; its 6 d FLOPs per unmasked pair and head take less at the
// bf16 tensor-core rate) and for dk/dv by its 8 d FLOPs per pair; both
// kernels here run far above either, limited by fp32 FMA issue.  What
// this design leaves on the table: the
// products run on the fp32 FMA pipes, not the tensor cores (no mma.sync or
// wgmma); tiles load synchronously (no cp.async or TMA, no double
// buffering); shared memory (149 KB for dq, 166 KB for dk/dv at d 128)
// allows one block per SM; the probabilities are recomputed in both
// kernels, as in the Pallas version.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // threads per block (16 x 16)

struct Params {
    const void* q;
    const void* k;
    const void* v;
    const void* dout;
    const float* lse;
    const float* dl;
    void* dq;
    void* dk;
    void* dv;
    int b, sq, sk, H, KV;
    long long q_sb, q_ss, q_sh;
    long long k_sb, k_ss, k_sh;
    long long v_sb, v_ss, v_sh;
    long long o_sb, o_ss, o_sh;     // strides of do
    int causal, q_offset, kv_len;
    float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
}

// rows [r0, r0 + n) of a strided [seq, d] slice into shared [n][S] fp32,
// zero past `limit`
template <typename T, int D, int S>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int r0, int n,
                                          int limit) {
    for (int i = threadIdx.x; i < n * D; i += NT) {
        const int r = i / D, c = i % D;
        const int row = r0 + r;
        dst[r * S + c] = row < limit ? to_f32(src[row * stride + c]) : 0.f;
    }
}

template <int D>
constexpr size_t dq_smem_bytes() {
    // Q, dO [BQ][D+1]; K, V [BK][D+1]; dS [BQ][BK+1]; lse, dl [BQ]
    return sizeof(float) * (2 * BQ * (D + 1) + 2 * BK * (D + 1) +
                            BQ * (BK + 1) + 2 * BQ);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
    // K, V [BK][D+1]; Q, dO [BQ][D+1]; P^T, dS^T [BK][BQ+1]; lse, dl [BQ]
    return sizeof(float) * (2 * BK * (D + 1) + 2 * BQ * (D + 1) +
                            2 * BK * (BQ + 1) + 2 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(Params p) {
    constexpr int S = D + 1;    // padded row stride: column reads of the
    constexpr int PS = BK + 1;  // tiles stay free of bank conflicts
    constexpr int NC = D / 16;  // dq columns per thread
    extern __shared__ float smem[];
    float* Qs = smem;
    float* dOs = Qs + BQ * S;
    float* Ks = dOs + BQ * S;
    float* Vs = Ks + BK * S;
    float* Ds = Vs + BK * S;
    float* lse_s = Ds + BQ * PS;
    float* dl_s = lse_s + BQ;

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int bi = blockIdx.z;
    const int kvh = h / (p.H / p.KV);
    const T* qg = static_cast<const T*>(p.q) + bi * p.q_sb + h * p.q_sh;
    const T* og = static_cast<const T*>(p.dout) + bi * p.o_sb + h * p.o_sh;
    const T* kg = static_cast<const T*>(p.k) + bi * p.k_sb + kvh * p.k_sh;
    const T* vg = static_cast<const T*>(p.v) + bi * p.v_sb + kvh * p.v_sh;
    const long long row_base = (static_cast<long long>(bi) * p.H + h) * p.sq;

    load_tile<T, D, S>(Qs, qg, p.q_ss, q0, BQ, p.sq);
    load_tile<T, D, S>(dOs, og, p.o_ss, q0, BQ, p.sq);
    for (int i = tid; i < BQ; i += NT) {
        const bool ok = q0 + i < p.sq;
        lse_s[i] = ok ? p.lse[row_base + q0 + i] : 0.f;
        dl_s[i] = ok ? p.dl[row_base + q0 + i] : 0.f;
    }

    float acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

    int k_end = p.kv_len;
    if (p.causal) {
        const int last_q = min(q0 + BQ, p.sq) - 1;
        k_end = min(k_end, p.q_offset + last_q + 1);
    }

    for (int k0 = 0; k0 < k_end; k0 += BK) {
        __syncthreads();   // the previous tile's readers are done
        load_tile<T, D, S>(Ks, kg, p.k_ss, k0, BK, p.kv_len);
        load_tile<T, D, S>(Vs, vg, p.v_ss, k0, BK, p.kv_len);
        __syncthreads();

        float s[4][4], dp[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
        for (int c = 0; c < D; ++c) {
            float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                qv[i] = Qs[(ty * 4 + i) * S + c];
                ov[i] = dOs[(ty * 4 + i) * S + c];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                kv[j] = Ks[(tx + 16 * j) * S + c];
                vv[j] = Vs[(tx + 16 * j) * S + c];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
                    dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
                }
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = ty * 4 + i;
            const int qpos = p.q_offset + q0 + r;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kpos = k0 + tx + 16 * j;
                const bool ok = kpos < p.kv_len &&
                                (!p.causal || kpos <= qpos);
                const float pr = ok ? expf(s[i][j] * p.scale - lse_s[r])
                                    : 0.f;
                Ds[r * PS + tx + 16 * j] = pr * (dp[i][j] - dl_s[r]) *
                                           p.scale;
            }
        }
        __syncthreads();

#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
            float dsv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) dsv[i] = Ds[(ty * 4 + i) * PS + kk];
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const float kc = Ks[kk * S + tx + 16 * c];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    acc[i][c] = fmaf(dsv[i], kc, acc[i][c]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int qi = q0 + ty * 4 + i;
        if (qi >= p.sq) continue;
        T* dst = static_cast<T*>(p.dq) +
                 ((static_cast<long long>(bi) * p.sq + qi) * p.H + h) * D;
#pragma unroll
        for (int c = 0; c < NC; ++c) store(dst + tx + 16 * c, acc[i][c]);
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(Params p) {
    constexpr int S = D + 1;
    constexpr int PS = BQ + 1;
    constexpr int NC = D / 16;
    extern __shared__ float smem[];
    float* Ks = smem;
    float* Vs = Ks + BK * S;
    float* Qs = Vs + BK * S;
    float* dOs = Qs + BQ * S;
    float* Pt = dOs + BQ * S;
    float* Dt = Pt + BK * PS;
    float* lse_s = Dt + BK * PS;
    float* dl_s = lse_s + BQ;

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int k0 = blockIdx.x * BK;
    const int kvh = blockIdx.y;
    const int bi = blockIdx.z;
    const int G = p.H / p.KV;
    const T* kg = static_cast<const T*>(p.k) + bi * p.k_sb + kvh * p.k_sh;
    const T* vg = static_cast<const T*>(p.v) + bi * p.v_sb + kvh * p.v_sh;

    load_tile<T, D, S>(Ks, kg, p.k_ss, k0, BK, p.kv_len);
    load_tile<T, D, S>(Vs, vg, p.v_ss, k0, BK, p.kv_len);

    float dk[4][NC], dv[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;

    // the first query tile whose rows can see this block's first key
    int q_begin = 0;
    if (p.causal) q_begin = max(0, k0 - p.q_offset) / BQ * BQ;
    const int q_end = k0 < p.kv_len ? p.sq : 0;

    for (int g = 0; g < G; ++g) {
        const int h = kvh * G + g;
        const T* qg = static_cast<const T*>(p.q) + bi * p.q_sb + h * p.q_sh;
        const T* og = static_cast<const T*>(p.dout) + bi * p.o_sb +
                      h * p.o_sh;
        const long long row_base =
            (static_cast<long long>(bi) * p.H + h) * p.sq;
        for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
            __syncthreads();   // the previous tile's readers are done
            load_tile<T, D, S>(Qs, qg, p.q_ss, q0, BQ, p.sq);
            load_tile<T, D, S>(dOs, og, p.o_ss, q0, BQ, p.sq);
            for (int i = tid; i < BQ; i += NT) {
                const bool ok = q0 + i < p.sq;
                lse_s[i] = ok ? p.lse[row_base + q0 + i] : 0.f;
                dl_s[i] = ok ? p.dl[row_base + q0 + i] : 0.f;
            }
            __syncthreads();

            float s[4][4], dp[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
            for (int c = 0; c < D; ++c) {
                float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    kv[i] = Ks[(ty * 4 + i) * S + c];
                    vv[i] = Vs[(ty * 4 + i) * S + c];
                }
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    qv[j] = Qs[(tx + 16 * j) * S + c];
                    ov[j] = dOs[(tx + 16 * j) * S + c];
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
                        dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
                    }
            }

#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = ty * 4 + i;
                const int kpos = k0 + r;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int qj = tx + 16 * j;
                    const int qrow = q0 + qj;
                    const int qpos = p.q_offset + qrow;
                    const bool ok = qrow < p.sq && kpos < p.kv_len &&
                                    (!p.causal || kpos <= qpos);
                    const float pr =
                        ok ? expf(s[i][j] * p.scale - lse_s[qj]) : 0.f;
                    Pt[r * PS + qj] = pr;
                    Dt[r * PS + qj] = pr * (dp[i][j] - dl_s[qj]) * p.scale;
                }
            }
            __syncthreads();

#pragma unroll 4
            for (int jj = 0; jj < BQ; ++jj) {
                float pv[4], dsv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    pv[i] = Pt[(ty * 4 + i) * PS + jj];
                    dsv[i] = Dt[(ty * 4 + i) * PS + jj];
                }
#pragma unroll
                for (int c = 0; c < NC; ++c) {
                    const float oc = dOs[jj * S + tx + 16 * c];
                    const float qc = Qs[jj * S + tx + 16 * c];
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        dv[i][c] = fmaf(pv[i], oc, dv[i][c]);
                        dk[i][c] = fmaf(dsv[i], qc, dk[i][c]);
                    }
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int kj = k0 + ty * 4 + i;
        if (kj >= p.sk) continue;
        const long long off =
            ((static_cast<long long>(bi) * p.sk + kj) * p.KV + kvh) * D;
        T* dkp = static_cast<T*>(p.dk) + off;
        T* dvp = static_cast<T*>(p.dv) + off;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            store(dkp + tx + 16 * c, dk[i][c]);
            store(dvp + tx + 16 * c, dv[i][c]);
        }
    }
}

template <typename T, int D>
int launch_dq(const Params& p, cudaStream_t stream) {
    const size_t smem = dq_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((p.sq + BQ - 1) / BQ, p.H, p.b);
    flash_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const Params& p, cudaStream_t stream) {
    const size_t smem = dkv_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((p.sk + BK - 1) / BK, p.KV, p.b);
    flash_bwd_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const Params& p, int head_dim, int which,
               cudaStream_t stream) {
    switch (head_dim) {
        case 16: return which ? launch_dkv<T, 16>(p, stream)
                              : launch_dq<T, 16>(p, stream);
        case 32: return which ? launch_dkv<T, 32>(p, stream)
                              : launch_dq<T, 32>(p, stream);
        case 64: return which ? launch_dkv<T, 64>(p, stream)
                              : launch_dq<T, 64>(p, stream);
        case 128: return which ? launch_dkv<T, 128>(p, stream)
                               : launch_dq<T, 128>(p, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

int run(int which, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* dl, void* dq,
        void* dk, void* dv, int dtype, int head_dim, int b, int sq, int sk,
        int H, int KV, long long q_sb, long long q_ss, long long q_sh,
        long long k_sb, long long k_ss, long long k_sh, long long v_sb,
        long long v_ss, long long v_sh, long long o_sb, long long o_ss,
        long long o_sh, int causal, int q_offset, int kv_len, float scale,
        void* stream) {
    Params p;
    p.q = q;
    p.k = k;
    p.v = v;
    p.dout = dout;
    p.lse = static_cast<const float*>(lse);
    p.dl = static_cast<const float*>(dl);
    p.dq = dq;
    p.dk = dk;
    p.dv = dv;
    p.b = b;
    p.sq = sq;
    p.sk = sk;
    p.H = H;
    p.KV = KV;
    p.q_sb = q_sb;
    p.q_ss = q_ss;
    p.q_sh = q_sh;
    p.k_sb = k_sb;
    p.k_ss = k_ss;
    p.k_sh = k_sh;
    p.v_sb = v_sb;
    p.v_ss = v_ss;
    p.v_sh = v_sh;
    p.o_sb = o_sb;
    p.o_ss = o_ss;
    p.o_sh = o_sh;
    p.causal = causal;
    p.q_offset = q_offset;
    p.kv_len = kv_len;
    p.scale = scale;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch_dim<float>(p, head_dim, which, st);
    if (dtype == 1) return launch_dim<__nv_bfloat16>(p, head_dim, which, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Dynamic shared memory of one block (which: 0 = dq, 1 = dk/dv), or -1
// for a head_dim the kernels do not take.
extern "C" long long repro_flash_bwd_smem_bytes(int which, int head_dim) {
    switch (head_dim) {
        case 16: return which ? dkv_smem_bytes<16>() : dq_smem_bytes<16>();
        case 32: return which ? dkv_smem_bytes<32>() : dq_smem_bytes<32>();
        case 64: return which ? dkv_smem_bytes<64>() : dq_smem_bytes<64>();
        case 128:
            return which ? dkv_smem_bytes<128>() : dq_smem_bytes<128>();
        default: return -1;
    }
}

// dtype: 0 = fp32, 1 = bf16.  Strides are in elements: q, do [b, sq, H, d]
// and k, v [b, sk, KV, d] by (batch, position, head).  Each returns a
// cudaError_t (0 on success); the launch is asynchronous on ``stream``.
extern "C" int repro_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dl, void* dq, int dtype, int head_dim,
    int b, int sq, int sk, int H, int KV,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int q_offset, int kv_len, float scale, void* stream) {
    return run(0, q, k, v, dout, lse, dl, dq, nullptr, nullptr, dtype,
               head_dim, b, sq, sk, H, KV, q_sb, q_ss, q_sh, k_sb, k_ss,
               k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, causal, q_offset,
               kv_len, scale, stream);
}

extern "C" int repro_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dl, void* dk, void* dv, int dtype,
    int head_dim, int b, int sq, int sk, int H, int KV,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int q_offset, int kv_len, float scale, void* stream) {
    return run(1, q, k, v, dout, lse, dl, nullptr, dk, dv, dtype, head_dim,
               b, sq, sk, H, KV, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
               v_ss, v_sh, o_sb, o_ss, o_sh, causal, q_offset, kv_len, scale,
               stream);
}
