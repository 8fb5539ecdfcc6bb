// Flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::flash_fwd
// (body _fwd_kernel): online-softmax attention that returns o and the fp32
// log-sum-exp, with scale 1/sqrt(d), the -1e30 mask value and the
// max(l, 1e-30) guard of the Pallas kernel.  Two generalisations over it:
//
//   * no query folding: query head h reads KV head h / (H / KV), so GQA
//     needs no reshape and a decode step (one query row) is served as is;
//   * q_offset and kv_len: query row i sits at position q_offset + i, keys
//     at positions >= kv_len are masked, and causal masks kpos > qpos.
//
// Layouts are the model side's, read in place through strides: q is
// [b, sq, H, d], k and v [b, sk, KV, d] (or one layer's slice of the KV
// cache).  The last dimension must be contiguous.  o is written contiguous
// [b, sq, H, d] in the input type, lse contiguous [b, H, sq] in fp32.
// Inputs are fp32 or bf16; every product and sum is fp32, as the Pallas
// kernel upcasts before each dot.
//
// Design (simple first): one block of 256 threads per (64 query rows, query
// head, batch row).  The block walks the keys in tiles of 64, staged in
// shared memory as fp32 next to the query tile, and keeps the running max,
// sum and output accumulator in registers.  Thread (ty, tx) of a 16 x 16
// grid owns query rows 4*ty .. 4*ty+3: it computes the scores of keys
// tx + 16*j (j < 4) and the output columns tx + 16*c (c < D/16).  Row
// maxima and sums reduce over the 16 lanes of a half-warp with shuffles.
// Causal blocks stop at the last key their rows can see.
//
// What bounds it on an H100: at decode (sq = 1) the kernel reads K and V
// once and is memory-bound, though at the serving path's kv_len <= 64 the
// launch itself dominates.  At long causal prefill it is compute-bound.
// What this design leaves on the table: the products run on the fp32 FMA
// pipes, not the tensor cores (no mma.sync or wgmma), with two shared-memory
// loads per FMA pair; tiles are loaded synchronously (no cp.async or TMA,
// no double buffering); a decode block computes 64 query rows to keep one;
// the G query heads that share a KV head each load it again.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // threads per block (16 x 16)
constexpr float NEG_INF = -1e30f;

struct Params {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    float* lse;
    int b, sq, H, KV;
    long long q_sb, q_ss, q_sh;
    long long k_sb, k_ss, k_sh;
    long long v_sb, v_ss, v_sh;
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

template <int D>
constexpr size_t smem_bytes() {
    // Q [BQ][D+1], K [BK][D+1], V [BK][D], P [BQ][BK+1], all fp32
    return sizeof(float) *
           (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Params p) {
    constexpr int QS = D + 1;   // padded strides keep the column reads of
    constexpr int KS = D + 1;   // Q, K and P free of bank conflicts
    constexpr int PS = BK + 1;
    constexpr int NC = D / 16;  // output columns per thread
    extern __shared__ float smem[];
    float* Qs = smem;
    float* Ks = Qs + BQ * QS;
    float* Vs = Ks + BK * KS;
    float* Ps = Vs + BK * D;

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int bi = blockIdx.z;
    const int kvh = h / (p.H / p.KV);
    const T* qg = static_cast<const T*>(p.q) + bi * p.q_sb + h * p.q_sh;
    const T* kg = static_cast<const T*>(p.k) + bi * p.k_sb + kvh * p.k_sh;
    const T* vg = static_cast<const T*>(p.v) + bi * p.v_sb + kvh * p.v_sh;

    for (int i = tid; i < BQ * D; i += NT) {
        const int r = i / D, c = i % D;
        const int qi = q0 + r;
        Qs[r * QS + c] = qi < p.sq ? to_f32(qg[qi * p.q_ss + c]) : 0.f;
    }

    float m[4], l[4], acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
    }

    int k_end = p.kv_len;
    if (p.causal) {
        const int last_q = min(q0 + BQ, p.sq) - 1;
        k_end = min(k_end, p.q_offset + last_q + 1);
    }

    for (int k0 = 0; k0 < k_end; k0 += BK) {
        __syncthreads();   // the previous tile's readers are done
        for (int i = tid; i < BK * D; i += NT) {
            const int r = i / D, c = i % D;
            const int kj = k0 + r;
            const bool ok = kj < p.kv_len;
            Ks[r * KS + c] = ok ? to_f32(kg[kj * p.k_ss + c]) : 0.f;
            Vs[r * D + c] = ok ? to_f32(vg[kj * p.v_ss + c]) : 0.f;
        }
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int c = 0; c < D; ++c) {
            float qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * QS + c];
#pragma unroll
            for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * KS + c];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qpos = p.q_offset + q0 + ty * 4 + i;
            float rmax = NEG_INF;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kpos = k0 + tx + 16 * j;
                const bool ok = kpos < p.kv_len && (!p.causal || kpos <= qpos);
                s[i][j] = ok ? s[i][j] * p.scale : NEG_INF;
                rmax = fmaxf(rmax, s[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
            const float m_new = fmaxf(m[i], rmax);
            const float corr = expf(m[i] - m_new);
            float rsum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float e = expf(s[i][j] - m_new);
                Ps[(ty * 4 + i) * PS + tx + 16 * j] = e;
                rsum += e;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
            l[i] = corr * l[i] + rsum;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
        }
        __syncthreads();

#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
            float pv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PS + kk];
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const float vv = Vs[kk * D + tx + 16 * c];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int qi = q0 + ty * 4 + i;
        if (qi >= p.sq) continue;
        const float lsum = fmaxf(l[i], 1e-30f);
        T* og = static_cast<T*>(p.o) +
                ((static_cast<long long>(bi) * p.sq + qi) * p.H + h) * D;
#pragma unroll
        for (int c = 0; c < NC; ++c) store(og + tx + 16 * c, acc[i][c] / lsum);
        if (tx == 0)
            p.lse[(static_cast<long long>(bi) * p.H + h) * p.sq + qi] =
                m[i] + logf(lsum);
    }
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
    const size_t smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((p.sq + BQ - 1) / BQ, p.H, p.b);
    flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const Params& p, int head_dim, cudaStream_t stream) {
    switch (head_dim) {
        case 16: return launch<T, 16>(p, stream);
        case 32: return launch<T, 32>(p, stream);
        case 64: return launch<T, 64>(p, stream);
        case 128: return launch<T, 128>(p, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// Dynamic shared memory of one block, or -1 for a head_dim it does not
// take.
extern "C" long long repro_flash_fwd_smem_bytes(int head_dim) {
    switch (head_dim) {
        case 16: return smem_bytes<16>();
        case 32: return smem_bytes<32>();
        case 64: return smem_bytes<64>();
        case 128: return smem_bytes<128>();
        default: return -1;
    }
}

// dtype: 0 = fp32, 1 = bf16.  Returns a cudaError_t (0 on success); the
// launch is asynchronous on ``stream`` and does not synchronise.
extern "C" int repro_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int head_dim, int b, int sq, int H, int KV,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int causal, int q_offset, int kv_len, float scale, void* stream) {
    Params p;
    p.q = q;
    p.k = k;
    p.v = v;
    p.o = o;
    p.lse = static_cast<float*>(lse);
    p.b = b;
    p.sq = sq;
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
    p.causal = causal;
    p.q_offset = q_offset;
    p.kv_len = kv_len;
    p.scale = scale;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch_dim<float>(p, head_dim, st);
    if (dtype == 1) return launch_dim<__nv_bfloat16>(p, head_dim, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
