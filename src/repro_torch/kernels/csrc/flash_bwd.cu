// Flash attention backward for Hopper (sm_90a), plain C interface: a dq
// and a dk/dv kernel for each input type.
//
// Replaces the Pallas TPU kernels of repro/kernels/flash_attention.py::
// flash_bwd (:219): _dq_kernel (:136, here repro_flash_bwd_dq for fp32
// and repro_flash_bwd_dq_mma for bf16) and _dkv_kernel (:177, here
// repro_flash_bwd_dkv for fp32 and repro_flash_bwd_dkv_mma for bf16).
// All recompute the probabilities from the forward's fp32 log-sum-exp and
// take dl = rowsum(o * do), computed in fp32 by the caller as the JAX
// package computes it outside its kernels:
//
//     p  = exp(q.k * scale - lse)        (0 where masked)
//     ds = p * (do.v - dl) * scale
//     dq = sum_keys ds k
//     dk = sum_{G query heads, queries} ds q
//     dv = sum_{G query heads, queries} p do
//
// Layouts are the model side's, read in place through strides, as in
// flash_fwd.cu: q [b, sq, H, DK], do [b, sq, H, DV], k [b, sk, KV, DK] and
// v [b, sk, KV, DV] (last dim contiguous); lse and dl contiguous [b, H, sq]
// fp32.  dq is written contiguous [b, sq, H, DK] in q's type, dk and dv
// contiguous [b, sk, KV, DK] and [b, sk, KV, DV] in k's type, exact zeros
// for keys at positions >= kv_len.  DK, the q.k width, sizes S = Q K^T,
// dQ and dK; DV, the v width, sizes dP = dO V^T and dV; the pairs are
// flash_fwd.cu's (the equal 16, 32, 64, 128 and MLA's (96, 64)).  Query
// head h reads KV head h / G (G = H / KV), query row i sits at position
// q_offset + i, keys at positions >= kv_len are masked and causal masks
// kpos > qpos.  Two differences from the Pallas kernels:
//
//   * GQA: the Pallas kernel folds the G query heads of a group into its
//     sequence axis head-major, so its dk/dv grid sums the group for free;
//     here the bf16 kernels pack the group's rows query-major (a dk/dv
//     block walks all G heads' rows, so the sum falls out of the walk) and
//     the fp32 dk/dv block loops over the G heads; either way the sum stays
//     in registers (no atomics, so the result is deterministic);
//   * positions: the Pallas kernels recover causal positions as row % sq,
//     valid only when sq == sk; these use q_offset + i as the forward does.
//
// Which kernel serves which type:
//
//   bf16 (every training step: the model computes in bf16), both on the
//   tensor cores through mma.sync m16n8k16 (flash_mma.cuh), with the
//   forward's packed rows: packed row r of KV head kvh is query r / G of
//   head kvh G + r % G, and lse and dl are gathered per packed row.
//   dq:   flash_bwd_dq_mma_kernel<DK, DV>, the forward's layout of work
//         (flash_fwd.cu): one block per (64 packed rows, KV head, batch
//         row); K and V tiles of 64 keys in a 2-stage cp.async ring; a
//         causal block stops at key q_offset + (last row) / G.  Per tile
//         each warp (16 rows) forms S = Q K^T and dP = dO V^T (Q, dO, K,
//         V by ldmatrix from shared memory), then on the fragments p =
//         exp2(S scale log2(e) - lse log2(e)) (0 where masked) and dS =
//         p (dP - dl) scale in fp32, rounds dS to bf16 in registers and
//         accumulates dQ += dS K (K by ldmatrix.trans from the tile already
//         in shared memory).  Q and dO stay in shared memory and are read
//         per k-step, which keeps the registers to dQ (64 a thread at d
//         128), S and dP (32 each).
//   dkv:  flash_bwd_dkv_mma_kernel<DK, DV>, the same design transposed: one
//         block per (64 keys, KV head, batch row), key blocks
//         slowest in a flat grid so the longest causal walks start first;
//         each warp owns 16 keys as the M dimension.  K and V are loaded
//         once (cp.async) and stay in shared memory; the block walks the
//         group's packed rows in tiles of 64 through a 2-stage cp.async
//         ring (Q, dO and the gathered lse, dl of each tile), from the tile
//         that holds packed row max(0, k0 - q_offset) G (the first to see
//         key k0) when causal.  Per 32-row chunk of a tile each warp forms
//         S^T = K Q^T and dP^T = V dO^T (K, V the A operand; Q, dO the B
//         operand stored n by k), then on the fragments P^T = exp2(S^T
//         scale log2(e) - lse log2(e)) and dS^T = P^T (dP^T - dl) scale,
//         rounds both to bf16 and accumulates dV += P^T dO and dK += dS^T
//         Q with dO and Q by ldmatrix.trans.  A warp skips chunks whose
//         last row cannot see its first key; masks are applied per
//         element only on edge chunks (past kv_len or n_rows, or a causal
//         diagonal).  dK and dV stay in fp32 registers (128 a thread at d
//         128); the 32-row chunks keep S^T and dP^T to 32 more.
//
//   fp32 (the CPU-parity checks on the card, held to 2e-5 / 1e-3, which
//   TF32 tensor cores would not meet): the first kernels on the fp32 FMA
//   pipes, every product and sum in fp32, 256 threads as a 16 x 16 grid:
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
// over HBM: 0.035 ms; its 6 d FLOPs per unmasked pair and head take 0.026
// ms at the bf16 tensor-core rate) and for dk/dv by its 8 d FLOPs per
// pair (0.035 ms).  What the bf16 designs leave on the table: mma.sync,
// not Hopper's wgmma with TMA and warp specialisation; the B operands
// (K, V for dq; Q, dO for dk/dv) re-read from shared memory by every warp
// and, in dk/dv, K and V re-read per 32-row chunk; two blocks of four
// warps per SM (104 KB of shared memory each at d 128); the probabilities
// recomputed in both kernels, as in the Pallas version.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "flash_mma.cuh"

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // threads per block (16 x 16)
// bf16 dk/dv: warps of 16 keys per block, and packed rows per S^T, dP^T
// pass of a warp (4 and 32 beat 8 warps and 16- or 64-row passes at the
// training shape; 64 rows spill at d 128)
constexpr int DKV_WARPS = 4;
constexpr int DKV_CHUNK = 32;

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
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

template <int DK, int DV>
constexpr size_t dq_smem_bytes() {
    // Q [BQ][DK+1], dO [BQ][DV+1]; K [BK][DK+1], V [BK][DV+1];
    // dS [BQ][BK+1]; lse, dl [BQ]
    return sizeof(float) * ((BQ + BK) * (DK + 1) + (BQ + BK) * (DV + 1) +
                            BQ * (BK + 1) + 2 * BQ);
}

template <int DK, int DV>
constexpr size_t dkv_smem_bytes() {
    // K [BK][DK+1], V [BK][DV+1]; Q [BQ][DK+1], dO [BQ][DV+1];
    // P^T, dS^T [BK][BQ+1]; lse, dl [BQ]
    return sizeof(float) * ((BK + BQ) * (DK + 1) + (BK + BQ) * (DV + 1) +
                            2 * BK * (BQ + 1) + 2 * BQ);
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(Params p) {
    constexpr int SK = DK + 1;  // padded row strides: column reads of the
    constexpr int SV = DV + 1;  // tiles stay free of bank conflicts
    constexpr int PS = BK + 1;
    constexpr int NC = DK / 16; // dq columns per thread
    extern __shared__ float smem[];
    float* Qs = smem;
    float* dOs = Qs + BQ * SK;
    float* Ks = dOs + BQ * SV;
    float* Vs = Ks + BK * SK;
    float* Ds = Vs + BK * SV;
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

    load_tile<T, DK, SK>(Qs, qg, p.q_ss, q0, BQ, p.sq);
    load_tile<T, DV, SV>(dOs, og, p.o_ss, q0, BQ, p.sq);
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
        load_tile<T, DK, SK>(Ks, kg, p.k_ss, k0, BK, p.kv_len);
        load_tile<T, DV, SV>(Vs, vg, p.v_ss, k0, BK, p.kv_len);
        __syncthreads();

        float s[4][4], dp[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
        for (int c = 0; c < DK; ++c) {
            float qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * SK + c];
#pragma unroll
            for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * SK + c];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }
#pragma unroll 4
        for (int c = 0; c < DV; ++c) {
            float ov[4], vv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) ov[i] = dOs[(ty * 4 + i) * SV + c];
#pragma unroll
            for (int j = 0; j < 4; ++j) vv[j] = Vs[(tx + 16 * j) * SV + c];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
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
                const float kc = Ks[kk * SK + tx + 16 * c];
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
                 ((static_cast<long long>(bi) * p.sq + qi) * p.H + h) * DK;
#pragma unroll
        for (int c = 0; c < NC; ++c) store(dst + tx + 16 * c, acc[i][c]);
    }
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(Params p) {
    constexpr int SK = DK + 1;
    constexpr int SV = DV + 1;
    constexpr int PS = BQ + 1;
    constexpr int NCK = DK / 16;    // dk columns per thread
    constexpr int NCV = DV / 16;    // dv columns per thread
    extern __shared__ float smem[];
    float* Ks = smem;
    float* Vs = Ks + BK * SK;
    float* Qs = Vs + BK * SV;
    float* dOs = Qs + BQ * SK;
    float* Pt = dOs + BQ * SV;
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

    load_tile<T, DK, SK>(Ks, kg, p.k_ss, k0, BK, p.kv_len);
    load_tile<T, DV, SV>(Vs, vg, p.v_ss, k0, BK, p.kv_len);

    float dk[4][NCK], dv[4][NCV];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < NCK; ++c) dk[i][c] = 0.f;
#pragma unroll
        for (int c = 0; c < NCV; ++c) dv[i][c] = 0.f;
    }

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
            load_tile<T, DK, SK>(Qs, qg, p.q_ss, q0, BQ, p.sq);
            load_tile<T, DV, SV>(dOs, og, p.o_ss, q0, BQ, p.sq);
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
            for (int c = 0; c < DK; ++c) {
                float kv[4], qv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) kv[i] = Ks[(ty * 4 + i) * SK + c];
#pragma unroll
                for (int j = 0; j < 4; ++j) qv[j] = Qs[(tx + 16 * j) * SK + c];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            }
#pragma unroll 4
            for (int c = 0; c < DV; ++c) {
                float vv[4], ov[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) vv[i] = Vs[(ty * 4 + i) * SV + c];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    ov[j] = dOs[(tx + 16 * j) * SV + c];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
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
                for (int c = 0; c < NCV; ++c) {
                    const float oc = dOs[jj * SV + tx + 16 * c];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        dv[i][c] = fmaf(pv[i], oc, dv[i][c]);
                }
#pragma unroll
                for (int c = 0; c < NCK; ++c) {
                    const float qc = Qs[jj * SK + tx + 16 * c];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        dk[i][c] = fmaf(dsv[i], qc, dk[i][c]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int kj = k0 + ty * 4 + i;
        if (kj >= p.sk) continue;
        const long long row =
            (static_cast<long long>(bi) * p.sk + kj) * p.KV + kvh;
        T* dkp = static_cast<T*>(p.dk) + row * DK;
        T* dvp = static_cast<T*>(p.dv) + row * DV;
#pragma unroll
        for (int c = 0; c < NCK; ++c) store(dkp + tx + 16 * c, dk[i][c]);
#pragma unroll
        for (int c = 0; c < NCV; ++c) store(dvp + tx + 16 * c, dv[i][c]);
    }
}

// ---------------------------------------------------------------------------
// dq, bf16: tensor cores, packed GQA rows, cp.async 2-stage ring

template <int DK, int DV>
constexpr size_t dq_mma_smem_bytes() {
    // Q [64][DK + 8], dO [64][DV + 8]; K [2 stages][64][DK + 8], V [2
    // stages][64][DV + 8]; all bf16
    return flash_mma::tile_bytes<DK>(BQ) + flash_mma::tile_bytes<DV>(BQ) +
           2 * flash_mma::tile_bytes<DK>(BK) +
           2 * flash_mma::tile_bytes<DV>(BK);
}

template <int DK, int DV>
__global__ void __launch_bounds__(128) flash_bwd_dq_mma_kernel(Params p) {
    using namespace flash_mma;
    constexpr int NTH = 128;            // 4 warps of 16 packed rows
    constexpr int BM = BQ;              // packed rows per block
    constexpr int RSK = row_stride<DK>();
    constexpr int RSV = row_stride<DV>();
    constexpr int KT = BK / 8;          // key n-tiles of S and dP
    constexpr int DT = DK / 8;          // q.k-width n-tiles of dQ
    constexpr float LOG2E = 1.4426950408889634f;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
    bf16* dOs = Qs + BM * RSK;
    bf16* Ks = dOs + BM * RSV;          // [2][BK][RSK]
    bf16* Vs = Ks + 2 * BK * RSK;       // [2][BK][RSV]

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int G = p.H / p.KV;
    const int n_rows = p.sq * G;
    // the last row blocks (the longest, when causal) start first
    const int r0 = (gridDim.x - 1 - blockIdx.x) * BM;
    const int kvh = blockIdx.y;
    const int bi = blockIdx.z;
    const bf16* qg = static_cast<const bf16*>(p.q) + bi * p.q_sb +
                     static_cast<long long>(kvh) * G * p.q_sh;
    const bf16* og = static_cast<const bf16*>(p.dout) + bi * p.o_sb +
                     static_cast<long long>(kvh) * G * p.o_sh;
    const bf16* kg = static_cast<const bf16*>(p.k) + bi * p.k_sb +
                     kvh * p.k_sh;
    const bf16* vg = static_cast<const bf16*>(p.v) + bi * p.v_sb +
                     kvh * p.v_sh;

    int k_end = p.kv_len;
    if (p.causal)
        k_end = min(k_end, p.q_offset + (min(r0 + BM, n_rows) - 1) / G + 1);
    const int n_tiles = (k_end + BK - 1) / BK;

    const int w0 = r0 + 16 * warp;
    const bool active = w0 < n_rows;
    const int w_end = !p.causal ? p.kv_len
        : min(p.kv_len, p.q_offset + (min(w0 + 16, n_rows) - 1) / G + 1);
    const int w_first_pos = p.q_offset + w0 / G;
    const float sl2 = p.scale * LOG2E;

    // rows g (h = 0) and g + 8 (h = 1): position, lse in log2 units, dl
    int qpos[2];
    bool row_ok[2];
    float lse2[2], dlr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = w0 + g + 8 * h;
        row_ok[h] = row < n_rows;
        qpos[h] = p.q_offset + row / G;
        lse2[h] = dlr[h] = 0.f;
        if (row_ok[h]) {
            const long long idx =
                (static_cast<long long>(bi) * p.H + kvh * G + row % G) *
                    p.sq + row / G;
            lse2[h] = p.lse[idx] * LOG2E;
            dlr[h] = p.dl[idx];
        }
    }

    load_packed<DK, NTH, BM>(Qs, qg, p.q_ss, p.q_sh, G, r0, n_rows, tid);
    load_packed<DV, NTH, BM>(dOs, og, p.o_ss, p.o_sh, G, r0, n_rows, tid);
    load_rows<DK, NTH, BK>(Ks, kg, p.k_ss, 0, p.kv_len, tid);
    load_rows<DV, NTH, BK>(Vs, vg, p.v_ss, 0, p.kv_len, tid);
    cp_async_commit();

    float acc[DT][4];
#pragma unroll
    for (int j = 0; j < DT; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
        const int k0 = it * BK;
        if (it + 1 < n_tiles) {
            const int st = (it + 1) & 1;
            load_rows<DK, NTH, BK>(Ks + st * BK * RSK, kg, p.k_ss, k0 + BK,
                                   p.kv_len, tid);
            load_rows<DV, NTH, BK>(Vs + st * BK * RSV, vg, p.v_ss, k0 + BK,
                                   p.kv_len, tid);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();

        if (active && k0 < w_end) {
            const bf16* Kt = Ks + (it & 1) * BK * RSK;
            const bf16* Vt = Vs + (it & 1) * BK * RSV;
            float s[KT][4], dp[KT][4];
#pragma unroll
            for (int j = 0; j < KT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < DK / 16; ++kk) {     // S = Q K^T
                uint32_t a[4];
                load_a<DK>(a, Qs, 16 * warp, 16 * kk, lane);
#pragma unroll
                for (int np = 0; np < KT / 2; ++np) {
                    uint32_t b[4];
                    load_b_nk<DK>(b, Kt, 16 * np, 16 * kk, lane);
                    mma_bf16(s[2 * np], a, b[0], b[1]);
                    mma_bf16(s[2 * np + 1], a, b[2], b[3]);
                }
            }
#pragma unroll
            for (int kk = 0; kk < DV / 16; ++kk) {     // dP = dO V^T
                uint32_t ao[4];
                load_a<DV>(ao, dOs, 16 * warp, 16 * kk, lane);
#pragma unroll
                for (int np = 0; np < KT / 2; ++np) {
                    uint32_t b[4];
                    load_b_nk<DV>(b, Vt, 16 * np, 16 * kk, lane);
                    mma_bf16(dp[2 * np], ao, b[0], b[1]);
                    mma_bf16(dp[2 * np + 1], ao, b[2], b[3]);
                }
            }

            // p and dS on the fragments (dS overwrites S)
            const bool edge = k0 + BK > p.kv_len ||
                              (p.causal && k0 + BK - 1 > w_first_pos);
#pragma unroll
            for (int j = 0; j < KT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int h = e >> 1;
                    const int kpos = k0 + 8 * j + 2 * t + (e & 1);
                    const bool ok = row_ok[h] &&
                        (!edge || (kpos < p.kv_len &&
                                   (!p.causal || kpos <= qpos[h])));
                    const float pr =
                        ok ? exp2f(s[j][e] * sl2 - lse2[h]) : 0.f;
                    s[j][e] = pr * (dp[j][e] - dlr[h]) * p.scale;
                }

            // dQ += dS K: dS rounded to bf16 is the A operand as it lies
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                uint32_t a[4];
                a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
                a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
                a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
                a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
                for (int np = 0; np < DT / 2; ++np) {
                    uint32_t b[4];
                    load_b_kn<DK>(b, Kt, 16 * kk, 16 * np, lane);
                    mma_bf16(acc[2 * np], a, b[0], b[1]);
                    mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
                }
            }
        }
        __syncthreads();
    }

    if (!active) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = w0 + g + 8 * h;
        if (!row_ok[h]) continue;
        bf16* dst = static_cast<bf16*>(p.dq) +
                    ((static_cast<long long>(bi) * p.sq + row / G) * p.H +
                     kvh * G + row % G) * DK;
#pragma unroll
        for (int j = 0; j < DT; ++j)
            *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * t) =
                pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
    }
}

template <int DK, int DV>
int launch_dq_mma(const Params& p, cudaStream_t stream) {
    const size_t smem = dq_mma_smem_bytes<DK, DV>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_mma_kernel<DK, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int rows = p.sq * (p.H / p.KV);
    const dim3 grid((rows + BQ - 1) / BQ, p.KV, p.b);
    flash_bwd_dq_mma_kernel<DK, DV><<<grid, 128, smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// dk/dv, bf16: tensor cores, keys per warp, packed GQA query rows in a
// cp.async 2-stage ring

template <int DK, int DV>
constexpr size_t dkv_mma_smem_bytes() {
    // K [16 DKV_WARPS][DK + 8], V [16 DKV_WARPS][DV + 8] bf16; Q [2
    // stages][64][DK + 8], dO [2 stages][64][DV + 8] bf16; lse, dl [2
    // stages][64] fp32
    return flash_mma::tile_bytes<DK>(16 * DKV_WARPS) +
           flash_mma::tile_bytes<DV>(16 * DKV_WARPS) +
           2 * flash_mma::tile_bytes<DK>(BQ) +
           2 * flash_mma::tile_bytes<DV>(BQ) + 4 * BQ * sizeof(float);
}

template <int DK, int DV>
__global__ void __launch_bounds__(32 * DKV_WARPS)
flash_bwd_dkv_mma_kernel(Params p) {
    using namespace flash_mma;
    constexpr int NTH = 32 * DKV_WARPS;
    constexpr int KB = 16 * DKV_WARPS;  // keys per block, 16 per warp
    constexpr int RC = DKV_CHUNK;
    constexpr int BM = BQ;              // packed rows per ring tile
    constexpr int RSK = row_stride<DK>();
    constexpr int RSV = row_stride<DV>();
    constexpr int CT = RC / 8;          // row n-tiles of S^T and dP^T
    constexpr int DTK = DK / 8;         // q.k-width n-tiles of dK
    constexpr int DTV = DV / 8;         // v-width n-tiles of dV
    constexpr float LOG2E = 1.4426950408889634f;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
    bf16* Vs = Ks + KB * RSK;
    bf16* Qs = Vs + KB * RSV;           // [2][BM][RSK]
    bf16* dOs = Qs + 2 * BM * RSK;      // [2][BM][RSV]
    float* lse_s = reinterpret_cast<float*>(dOs + 2 * BM * RSV); // [2][BM]
    float* dl_s = lse_s + 2 * BM;                                // [2][BM]

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int G = p.H / p.KV;
    const int n_rows = p.sq * G;
    // one flat grid, key blocks slowest: every (KV head, batch row) of key
    // block 0 (the longest walk, when causal) starts before key block 1
    const int kvh = blockIdx.x % p.KV;
    const int bi = (blockIdx.x / p.KV) % p.b;
    const int k0 = blockIdx.x / (p.KV * p.b) * KB;
    const long long qh = static_cast<long long>(kvh) * G;
    const bf16* qg = static_cast<const bf16*>(p.q) + bi * p.q_sb +
                     qh * p.q_sh;
    const bf16* og = static_cast<const bf16*>(p.dout) + bi * p.o_sb +
                     qh * p.o_sh;
    const bf16* kg = static_cast<const bf16*>(p.k) + bi * p.k_sb +
                     kvh * p.k_sh;
    const bf16* vg = static_cast<const bf16*>(p.v) + bi * p.v_sb +
                     kvh * p.v_sh;
    const long long row_base = (static_cast<long long>(bi) * p.H + qh) *
                               p.sq;
    const float* lseg = p.lse + row_base;
    const float* dlg = p.dl + row_base;

    // the causal start: packed row max(0, k0 - q_offset) G is the first
    // to see key k0; walk from the ring tile that holds it
    const int t_begin = p.causal ? max(0, k0 - p.q_offset) * G / BM : 0;
    const int n_tiles = k0 < p.kv_len
        ? max(0, (n_rows + BM - 1) / BM - t_begin) : 0;

    const int kw0 = k0 + 16 * warp;     // this warp's first key
    const bool active = kw0 < p.kv_len;
    const float sl2 = p.scale * LOG2E;

    // K, V and the first tile (none when the block has nothing to walk:
    // its dK and dV are zeros, and no copy is left in flight at exit)
    if (n_tiles > 0) {
        const int r0 = t_begin * BM;
        load_rows<DK, NTH, KB>(Ks, kg, p.k_ss, k0, p.kv_len, tid);
        load_rows<DV, NTH, KB>(Vs, vg, p.v_ss, k0, p.kv_len, tid);
        load_packed<DK, NTH, BM>(Qs, qg, p.q_ss, p.q_sh, G, r0, n_rows,
                                 tid);
        load_packed<DV, NTH, BM>(dOs, og, p.o_ss, p.o_sh, G, r0, n_rows,
                                 tid);
        load_packed_f32<NTH, BM>(lse_s, lseg, p.sq, G, r0, n_rows, tid);
        load_packed_f32<NTH, BM>(dl_s, dlg, p.sq, G, r0, n_rows, tid);
    }
    cp_async_commit();

    float dk[DTK][4], dv[DTV][4];
#pragma unroll
    for (int j = 0; j < DTK; ++j)
        dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
#pragma unroll
    for (int j = 0; j < DTV; ++j)
        dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
        const int r0 = (t_begin + it) * BM;
        if (it + 1 < n_tiles) {
            const int st = (it + 1) & 1;
            load_packed<DK, NTH, BM>(Qs + st * BM * RSK, qg, p.q_ss,
                                     p.q_sh, G, r0 + BM, n_rows, tid);
            load_packed<DV, NTH, BM>(dOs + st * BM * RSV, og, p.o_ss,
                                     p.o_sh, G, r0 + BM, n_rows, tid);
            load_packed_f32<NTH, BM>(lse_s + st * BM, lseg, p.sq, G,
                                     r0 + BM, n_rows, tid);
            load_packed_f32<NTH, BM>(dl_s + st * BM, dlg, p.sq, G, r0 + BM,
                                     n_rows, tid);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();

        const bf16* Qt = Qs + (it & 1) * BM * RSK;
        const bf16* dOt = dOs + (it & 1) * BM * RSV;
        const float* lse_t = lse_s + (it & 1) * BM;
        const float* dl_t = dl_s + (it & 1) * BM;
#pragma unroll
        for (int c0 = 0; c0 < BM; c0 += RC) {
            const int h0 = r0 + c0;     // the chunk's first packed row
            // warp-uniform skips: no active key, no row, or (causal) no
            // row of the chunk that sees the warp's first key
            if (!active || h0 >= n_rows ||
                (p.causal &&
                 p.q_offset + (min(h0 + RC, n_rows) - 1) / G < kw0))
                continue;
            // S^T = K Q^T and dP^T = V dO^T: K, V rows are the A operand,
            // Q and dO rows the B operand stored n by k
            float s[CT][4], dp[CT][4];
#pragma unroll
            for (int j = 0; j < CT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < DK / 16; ++kk) {     // S^T = K Q^T
                uint32_t a[4];
                load_a<DK>(a, Ks, 16 * warp, 16 * kk, lane);
#pragma unroll
                for (int np = 0; np < CT / 2; ++np) {
                    uint32_t b[4];
                    load_b_nk<DK>(b, Qt, c0 + 16 * np, 16 * kk, lane);
                    mma_bf16(s[2 * np], a, b[0], b[1]);
                    mma_bf16(s[2 * np + 1], a, b[2], b[3]);
                }
            }
#pragma unroll
            for (int kk = 0; kk < DV / 16; ++kk) {     // dP^T = V dO^T
                uint32_t av[4];
                load_a<DV>(av, Vs, 16 * warp, 16 * kk, lane);
#pragma unroll
                for (int np = 0; np < CT / 2; ++np) {
                    uint32_t b[4];
                    load_b_nk<DV>(b, dOt, c0 + 16 * np, 16 * kk, lane);
                    mma_bf16(dp[2 * np], av, b[0], b[1]);
                    mma_bf16(dp[2 * np + 1], av, b[2], b[3]);
                }
            }

            // P^T and dS^T on the fragments (P^T over S^T, dS^T over dP^T);
            // element e of n-tile j: key kw0 + g + 8 (e / 2), packed row
            // h0 + 8 j + 2 t + e % 2
            const bool edge = h0 + RC > n_rows || kw0 + 16 > p.kv_len ||
                              (p.causal && kw0 + 15 > p.q_offset + h0 / G);
#pragma unroll
            for (int j = 0; j < CT; ++j) {
                const int c = c0 + 8 * j + 2 * t;
                const float2 l2 = *reinterpret_cast<const float2*>(lse_t + c);
                const float2 d2 = *reinterpret_cast<const float2*>(dl_t + c);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int row = r0 + c + (e & 1);
                    const int kpos = kw0 + g + 8 * (e >> 1);
                    const bool ok = !edge ||
                        (row < n_rows && kpos < p.kv_len &&
                         (!p.causal || kpos <= p.q_offset + row / G));
                    const float lse2 = ((e & 1) ? l2.y : l2.x) * LOG2E;
                    const float pr = ok ? exp2f(s[j][e] * sl2 - lse2) : 0.f;
                    s[j][e] = pr;
                    dp[j][e] = pr * (dp[j][e] - ((e & 1) ? d2.y : d2.x)) *
                               p.scale;
                }
            }

            // dV += P^T dO and dK += dS^T Q: P^T and dS^T rounded to bf16
            // are A operands as they lie; dO and Q by ldmatrix.trans
#pragma unroll
            for (int kk = 0; kk < RC / 16; ++kk) {
                uint32_t ap[4], ad[4];
                ap[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
                ap[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
                ap[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
                ap[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
                ad[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
                ad[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
                ad[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
                ad[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
                for (int np = 0; np < DTV / 2; ++np) {
                    uint32_t b[4];
                    load_b_kn<DV>(b, dOt, c0 + 16 * kk, 16 * np, lane);
                    mma_bf16(dv[2 * np], ap, b[0], b[1]);
                    mma_bf16(dv[2 * np + 1], ap, b[2], b[3]);
                }
#pragma unroll
                for (int np = 0; np < DTK / 2; ++np) {
                    uint32_t b[4];
                    load_b_kn<DK>(b, Qt, c0 + 16 * kk, 16 * np, lane);
                    mma_bf16(dk[2 * np], ad, b[0], b[1]);
                    mma_bf16(dk[2 * np + 1], ad, b[2], b[3]);
                }
            }
        }
        __syncthreads();
    }

    // every key of the block below sk is written, zeros for keys past
    // kv_len (and for keys no row sees)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int key = kw0 + g + 8 * h;
        if (key >= p.sk) continue;
        const long long row =
            (static_cast<long long>(bi) * p.sk + key) * p.KV + kvh;
        bf16* dkp = static_cast<bf16*>(p.dk) + row * DK;
        bf16* dvp = static_cast<bf16*>(p.dv) + row * DV;
#pragma unroll
        for (int j = 0; j < DTK; ++j)
            *reinterpret_cast<uint32_t*>(dkp + 8 * j + 2 * t) =
                pack_bf16(dk[j][2 * h], dk[j][2 * h + 1]);
#pragma unroll
        for (int j = 0; j < DTV; ++j)
            *reinterpret_cast<uint32_t*>(dvp + 8 * j + 2 * t) =
                pack_bf16(dv[j][2 * h], dv[j][2 * h + 1]);
    }
}

template <int DK, int DV>
int launch_dkv_mma(const Params& p, cudaStream_t stream) {
    const size_t smem = dkv_mma_smem_bytes<DK, DV>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_mma_kernel<DK, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    constexpr int KB = 16 * DKV_WARPS;
    const long long blocks =
        static_cast<long long>((p.sk + KB - 1) / KB) * p.KV * p.b;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    flash_bwd_dkv_mma_kernel<DK, DV>
        <<<static_cast<unsigned>(blocks), 32 * DKV_WARPS, smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// dq (fp32) and dk/dv: the PR 12 kernels' launchers

template <typename T, int DK, int DV>
int launch_dq(const Params& p, cudaStream_t stream) {
    const size_t smem = dq_smem_bytes<DK, DV>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, DK, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((p.sq + BQ - 1) / BQ, p.H, p.b);
    flash_bwd_dq_kernel<T, DK, DV><<<grid, NT, smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int DK, int DV>
int launch_dkv(const Params& p, cudaStream_t stream) {
    const size_t smem = dkv_smem_bytes<DK, DV>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T, DK, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((p.sk + BK - 1) / BK, p.KV, p.b);
    flash_bwd_dkv_kernel<T, DK, DV><<<grid, NT, smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

// which: 0 = dq, 1 = dk/dv (fp32 only); 2 = dq, 3 = dk/dv (bf16 only)
template <int DK, int DV>
int launch_which(const Params& p, int which, int dtype,
                 cudaStream_t stream) {
    if (dtype == 0 && which == 0) return launch_dq<float, DK, DV>(p, stream);
    if (dtype == 0 && which == 1)
        return launch_dkv<float, DK, DV>(p, stream);
    if (dtype == 1 && which == 2) return launch_dq_mma<DK, DV>(p, stream);
    if (dtype == 1 && which == 3) return launch_dkv_mma<DK, DV>(p, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

// the instantiated (q.k width, v width) pairs, flash_fwd.cu's; any other
// is refused
int launch_dims(const Params& p, int dk, int dv, int which, int dtype,
                cudaStream_t stream) {
    if (dk == 96 && dv == 64)
        return launch_which<96, 64>(p, which, dtype, stream);
    if (dk != dv) return static_cast<int>(cudaErrorInvalidValue);
    switch (dk) {
        case 16: return launch_which<16, 16>(p, which, dtype, stream);
        case 32: return launch_which<32, 32>(p, which, dtype, stream);
        case 64: return launch_which<64, 64>(p, which, dtype, stream);
        case 128: return launch_which<128, 128>(p, which, dtype, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

int run(int which, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* dl, void* dq,
        void* dk, void* dv, int dtype, int dkw, int dvw, int b, int sq,
        int sk,
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
    return launch_dims(p, dkw, dvw, which, dtype,
                       static_cast<cudaStream_t>(stream));
}

}  // namespace

namespace {

template <int DK, int DV>
long long pair_smem_bytes(int which) {
    switch (which) {
        case 0: return dq_smem_bytes<DK, DV>();
        case 1: return dkv_smem_bytes<DK, DV>();
        case 2: return dq_mma_smem_bytes<DK, DV>();
        case 3: return dkv_mma_smem_bytes<DK, DV>();
        default: return -1;
    }
}

}  // namespace

// Dynamic shared memory of one block (which: 0 = dq fp32, 1 = dk/dv fp32,
// 2 = dq bf16, 3 = dk/dv bf16), or -1 for a kernel or a (q.k width, v
// width) pair it does not have.
extern "C" long long repro_flash_bwd_smem_bytes(int which, int dk, int dv) {
    if (dk == 96 && dv == 64) return pair_smem_bytes<96, 64>(which);
    if (dk != dv) return -1;
    switch (dk) {
        case 16: return pair_smem_bytes<16, 16>(which);
        case 32: return pair_smem_bytes<32, 32>(which);
        case 64: return pair_smem_bytes<64, 64>(which);
        case 128: return pair_smem_bytes<128, 128>(which);
        default: return -1;
    }
}

// dtype: 0 = fp32, 1 = bf16; dk, dv the q.k and v widths (an
// instantiated pair, else cudaErrorInvalidValue).  Strides are in
// elements: q, do [b, sq, H, ·] and k, v [b, sk, KV, ·] by (batch,
// position, head).  Each returns a
// cudaError_t (0 on success); the launch is asynchronous on ``stream``.
// repro_flash_bwd_dq and repro_flash_bwd_dkv take fp32;
// repro_flash_bwd_dq_mma and repro_flash_bwd_dkv_mma take bf16 whose data
// pointers and strides are multiples of 16 bytes (cp.async); each refuses
// another dtype.
extern "C" int repro_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dl, void* dq, int dtype, int dk, int dv,
    int b, int sq, int sk, int H, int KV,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int q_offset, int kv_len, float scale, void* stream) {
    return run(0, q, k, v, dout, lse, dl, dq, nullptr, nullptr, dtype,
               dk, dv, b, sq, sk, H, KV, q_sb, q_ss, q_sh, k_sb, k_ss,
               k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, causal, q_offset,
               kv_len, scale, stream);
}

extern "C" int repro_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dl, void* dk, void* dv, int dtype,
    int dkw, int dvw, int b, int sq, int sk, int H, int KV,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int q_offset, int kv_len, float scale, void* stream) {
    return run(1, q, k, v, dout, lse, dl, nullptr, dk, dv, dtype, dkw, dvw,
               b, sq, sk, H, KV, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
               v_ss, v_sh, o_sb, o_ss, o_sh, causal, q_offset, kv_len, scale,
               stream);
}

extern "C" int repro_flash_bwd_dq_mma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dl, void* dq, int dtype, int dk, int dv,
    int b, int sq, int sk, int H, int KV,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int q_offset, int kv_len, float scale, void* stream) {
    return run(2, q, k, v, dout, lse, dl, dq, nullptr, nullptr, dtype,
               dk, dv, b, sq, sk, H, KV, q_sb, q_ss, q_sh, k_sb, k_ss,
               k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, causal, q_offset,
               kv_len, scale, stream);
}

extern "C" int repro_flash_bwd_dkv_mma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dl, void* dk, void* dv, int dtype,
    int dkw, int dvw, int b, int sq, int sk, int H, int KV,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int q_offset, int kv_len, float scale, void* stream) {
    return run(3, q, k, v, dout, lse, dl, nullptr, dk, dv, dtype, dkw, dvw,
               b, sq, sk, H, KV, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
               v_ss, v_sh, o_sb, o_ss, o_sh, causal, q_offset, kv_len, scale,
               stream);
}
