// Flash attention forward for Hopper (sm_90a), plain C interface: two
// kernels, one per input type.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::flash_fwd
// (body _fwd_kernel): online-softmax attention that returns o and the fp32
// log-sum-exp, with scale 1/sqrt(d), the -1e30 mask value and the
// max(l, 1e-30) guard of the Pallas kernel.  Two generalisations over it:
//
//   * GQA without the Pallas kernel's head-major fold (whose positions,
//     row % sq, hold only for sq == sk): query head h reads KV head
//     h / (H / KV), and a decode step (one query row) is served as is;
//   * q_offset and kv_len: query row i sits at position q_offset + i, keys
//     at positions >= kv_len are masked, and causal masks kpos > qpos;
//   * paged rows (the pipelined engine's decode wave): with `kv_lens` and
//     `pages` set, batch row bi reads its keys and values from page
//     pages[bi] of k and v (base k + pages[bi] * k_sb) and masks keys at
//     positions >= kv_lens[bi], both read from device memory, so one
//     launch serves R requests at R lengths where the JAX package vmaps
//     a scalar-position decode over the requests.  Rows may share a page
//     (idle rows all compute on the trash page); o and lse stay indexed
//     by bi.
//
// Layouts are the model side's, read in place through strides: q is
// [b, sq, H, DK], k [b, sk, KV, DK] and v [b, sk, KV, DV] (or one layer's
// slice of the KV cache).  The last dimension must be contiguous.  o is
// written contiguous [b, sq, H, DV] in the input type, lse contiguous
// [b, H, sq] in fp32.
//
// Two widths: DK, the q.k width (the S = Q K^T products, the Q and K
// tiles), and DV, the v width (the P V products, O, the V tiles).  The
// instantiated pairs are the equal ones (16, 32, 64, 128) and (96, 64),
// multi-head latent attention's (MiniCPM3, DeepSeek-V2: 64 nope + 32 rope
// dims for q.k, 64 for v).  The scale is the caller's (1/sqrt(DK)).
//
// Which kernel serves which type:
//
//   flash_fwd_mma_kernel<DK, DV, NW> (bf16, every main path: serving casts
//   the weights to bf16, training computes in bf16).  Tensor cores through
//   mma.sync m16n8k16 (flash_mma.cuh).  A block owns one KV head of one
//   batch row and 16 NW rows packed by GQA group, query-major: packed row
//   r is query r / G of head kvh G + r % G, so one K/V tile in shared
//   memory serves all G heads of the group, a row's position is q_offset
//   + r / G, and a causal block stops at key q_offset + (its last row) /
//   G.  Each warp owns 16 rows: S = Q K^T (Q and K by ldmatrix) is a
//   16 x 64 fp32 fragment; mask, scale and the online softmax run on it
//   (exp2 with scale log2(e) folded in, row max and sum over the quad);
//   P is rounded to bf16 in registers and is the A operand of O += P V (V
//   by ldmatrix.trans); O stays in fp32 registers.  K and V tiles of 64
//   keys go into a 2-stage ring filled by 16-byte cp.async (zero fill past
//   kv_len): tile j + 1 loads while tile j computes.  The epilogue divides
//   by max(l, 1e-30) and writes o in bf16; lse comes from the unrounded
//   fp32 sums.  NW = 4 (64 rows) in general; NW = 1 (16 rows) when sq G
//   <= 16, which covers granite decode (4 rows), zamba2 decode (1 row),
//   MLA decode (G = 1: one row of the 16) and short prefill, so no warp
//   of a decode block idles.  (The other
//   choice, four warps splitting the keys and merging (m, l, O) through
//   shared memory, splits a single tile at the serving paths' kv_len <=
//   64 and adds a merge; a one-warp block does the same work with none.)
//
//   flash_fwd_kernel<float, DK, DV> (fp32: the CPU-parity checks on the
//   card, held to 2e-5, which TF32 tensor cores would not meet).  The first
//   design: one block of 256 threads per (64 query rows, query head, batch
//   row) walks the key tiles staged in shared memory as fp32; thread (ty,
//   tx) of a 16 x 16 grid owns rows 4 ty .. 4 ty + 3, keys tx + 16 j and
//   output columns tx + 16 c; products on the fp32 FMA pipes.
//
// What bounds it on an H100: at decode (sq = 1) the kernel reads K and V
// once and is memory-bound, though at the serving paths' kv_len <= 64
// the launch and one tile's load latency dominate.  At the training shape
// ([8, 512, 32, 128] causal) the bound is bytes (q, k, v, o: 0.025 ms),
// with the tensor-core FLOPs close behind (0.017 ms).
// What the bf16 design leaves on the table: mma.sync reaches a fraction of
// the rate of Hopper's wgmma (asynchronous warpgroup products with TMA
// loads and warp specialisation); every block of 64 packed rows reads its
// KV head's K and V tiles again (through L2), and at d 128 its 87 KB of
// shared memory (Q and the 2-stage ring) lets two blocks of four warps
// share an SM; Q is re-read from shared memory by each key tile; o is
// stored from the fragments in 4-byte pieces, not staged for 16-byte
// stores; and decode is not split over blocks along the keys
// (flash-decoding), so a long cache would run on KV x b blocks.  Causal
// blocks run longest first, so the grid's tail is short blocks.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "flash_mma.cuh"

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
    const int* kv_lens;   // per batch row, or null: kv_len for every row
    const int* pages;     // per batch row's page of k and v, or null: bi
};

// batch row bi's key count and the offset of its keys and values
__device__ __forceinline__ int row_kv_len(const Params& p, int bi) {
    return p.kv_lens ? p.kv_lens[bi] : p.kv_len;
}
__device__ __forceinline__ long long row_page(const Params& p, int bi) {
    return p.pages ? p.pages[bi] : bi;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int DK, int DV>
constexpr size_t smem_bytes() {
    // Q [BQ][DK+1], K [BK][DK+1], V [BK][DV], P [BQ][BK+1], all fp32
    return sizeof(float) *
           (BQ * (DK + 1) + BK * (DK + 1) + BK * DV + BQ * (BK + 1));
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Params p) {
    constexpr int QS = DK + 1;  // padded strides keep the column reads of
    constexpr int KS = DK + 1;  // Q, K and P free of bank conflicts
    constexpr int PS = BK + 1;
    constexpr int NC = DV / 16; // output columns per thread
    extern __shared__ float smem[];
    float* Qs = smem;
    float* Ks = Qs + BQ * QS;
    float* Vs = Ks + BK * KS;
    float* Ps = Vs + BK * DV;

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int bi = blockIdx.z;
    const int kvh = h / (p.H / p.KV);
    const int kv_len = row_kv_len(p, bi);
    const long long pg = row_page(p, bi);
    const T* qg = static_cast<const T*>(p.q) + bi * p.q_sb + h * p.q_sh;
    const T* kg = static_cast<const T*>(p.k) + pg * p.k_sb + kvh * p.k_sh;
    const T* vg = static_cast<const T*>(p.v) + pg * p.v_sb + kvh * p.v_sh;

    for (int i = tid; i < BQ * DK; i += NT) {
        const int r = i / DK, c = i % DK;
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

    int k_end = kv_len;
    if (p.causal) {
        const int last_q = min(q0 + BQ, p.sq) - 1;
        k_end = min(k_end, p.q_offset + last_q + 1);
    }

    for (int k0 = 0; k0 < k_end; k0 += BK) {
        __syncthreads();   // the previous tile's readers are done
        for (int i = tid; i < BK * DK; i += NT) {
            const int r = i / DK, c = i % DK;
            const int kj = k0 + r;
            Ks[r * KS + c] = kj < kv_len ? to_f32(kg[kj * p.k_ss + c]) : 0.f;
        }
        for (int i = tid; i < BK * DV; i += NT) {
            const int r = i / DV, c = i % DV;
            const int kj = k0 + r;
            Vs[r * DV + c] = kj < kv_len ? to_f32(vg[kj * p.v_ss + c]) : 0.f;
        }
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int c = 0; c < DK; ++c) {
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
                const bool ok = kpos < kv_len && (!p.causal || kpos <= qpos);
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
                const float vv = Vs[kk * DV + tx + 16 * c];
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
                ((static_cast<long long>(bi) * p.sq + qi) * p.H + h) * DV;
#pragma unroll
        for (int c = 0; c < NC; ++c) store(og + tx + 16 * c, acc[i][c] / lsum);
        if (tx == 0)
            p.lse[(static_cast<long long>(bi) * p.H + h) * p.sq + qi] =
                m[i] + logf(lsum);
    }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, packed GQA rows, cp.async 2-stage ring

template <int DK, int DV, int NW>
constexpr size_t mma_smem_bytes() {
    // Q [16 NW][DK + 8]; K [2 stages][64][DK + 8]; V [2 stages][64][DV + 8];
    // all bf16
    return flash_mma::tile_bytes<DK>(16 * NW) +
           2 * flash_mma::tile_bytes<DK>(BK) +
           2 * flash_mma::tile_bytes<DV>(BK);
}

template <int DK, int DV, int NW>
__global__ void __launch_bounds__(32 * NW)
flash_fwd_mma_kernel(Params p) {
    using namespace flash_mma;
    constexpr int NT = 32 * NW;
    constexpr int BM = 16 * NW;         // packed rows per block
    constexpr int RSK = row_stride<DK>();
    constexpr int RSV = row_stride<DV>();
    constexpr int KT = BK / 8;          // key n-tiles of S
    constexpr int DT = DV / 8;          // v-width n-tiles of O
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
    bf16* Ks = Qs + BM * RSK;           // [2][BK][RSK]
    bf16* Vs = Ks + 2 * BK * RSK;       // [2][BK][RSV]

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int G = p.H / p.KV;
    const int n_rows = p.sq * G;
    // the last row blocks (the longest, when causal) start first, so the
    // grid's tail is short blocks
    const int r0 = (gridDim.x - 1 - blockIdx.x) * BM;
    const int kvh = blockIdx.y;
    const int bi = blockIdx.z;
    const int kv_len = row_kv_len(p, bi);
    const long long pg = row_page(p, bi);
    const bf16* qg = static_cast<const bf16*>(p.q) + bi * p.q_sb +
                     static_cast<long long>(kvh) * G * p.q_sh;
    const bf16* kg = static_cast<const bf16*>(p.k) + pg * p.k_sb +
                     kvh * p.k_sh;
    const bf16* vg = static_cast<const bf16*>(p.v) + pg * p.v_sb +
                     kvh * p.v_sh;

    // the block's keys: a causal block stops after its last row's position
    int k_end = kv_len;
    if (p.causal)
        k_end = min(k_end, p.q_offset + (min(r0 + BM, n_rows) - 1) / G + 1);
    const int n_tiles = (k_end + BK - 1) / BK;

    // this warp's 16 rows and the keys they can see
    const int w0 = r0 + 16 * warp;
    const bool active = w0 < n_rows;
    const int w_end = !p.causal ? kv_len
        : min(kv_len, p.q_offset + (min(w0 + 16, n_rows) - 1) / G + 1);
    const int w_first_pos = p.q_offset + w0 / G;
    const int qpos[2] = {p.q_offset + (w0 + g) / G,
                         p.q_offset + (w0 + g + 8) / G};
    const float sl2 = p.scale * 1.4426950408889634f;   // scale log2(e)

    load_packed<DK, NT, BM>(Qs, qg, p.q_ss, p.q_sh, G, r0, n_rows, tid);
    load_rows<DK, NT, BK>(Ks, kg, p.k_ss, 0, kv_len, tid);
    load_rows<DV, NT, BK>(Vs, vg, p.v_ss, 0, kv_len, tid);
    cp_async_commit();

    float o[DT][4];
#pragma unroll
    for (int j = 0; j < DT; ++j)
        o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};    // running max, log2 units
    float l[2] = {0.f, 0.f};            // this lane's part of the row sums

    for (int it = 0; it < n_tiles; ++it) {
        const int k0 = it * BK;
        if (it + 1 < n_tiles) {         // the next tile into the other stage
            const int st = (it + 1) & 1;
            load_rows<DK, NT, BK>(Ks + st * BK * RSK, kg, p.k_ss, k0 + BK,
                                  kv_len, tid);
            load_rows<DV, NT, BK>(Vs + st * BK * RSV, vg, p.v_ss, k0 + BK,
                                  kv_len, tid);
        }
        cp_async_commit();              // (an empty group on the last tile)
        cp_async_wait<1>();             // this tile (and Q) have landed
        __syncthreads();

        if (active && k0 < w_end) {
            const bf16* Kt = Ks + (it & 1) * BK * RSK;
            const bf16* Vt = Vs + (it & 1) * BK * RSV;
            float s[KT][4];
#pragma unroll
            for (int j = 0; j < KT; ++j)
                s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
            for (int kk = 0; kk < DK / 16; ++kk) {
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

            // scale into log2 units, mask where a key is out of reach
            const bool edge = k0 + BK > kv_len ||
                              (p.causal && k0 + BK - 1 > w_first_pos);
#pragma unroll
            for (int j = 0; j < KT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int kpos = k0 + 8 * j + 2 * t + (e & 1);
                    const bool ok = !edge || (kpos < kv_len &&
                                    (!p.causal || kpos <= qpos[e >> 1]));
                    s[j][e] = ok ? s[j][e] * sl2 : NEG_INF;
                }

            // online softmax, rows g (h = 0) and g + 8 (h = 1)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float mx = m[h];
#pragma unroll
                for (int j = 0; j < KT; ++j)
                    mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
                mx = quad_max(mx);
                const float corr = exp2f(m[h] - mx);
                m[h] = mx;
                float sum = 0.f;
#pragma unroll
                for (int j = 0; j < KT; ++j) {
                    s[j][2 * h] = exp2f(s[j][2 * h] - mx);
                    s[j][2 * h + 1] = exp2f(s[j][2 * h + 1] - mx);
                    sum += s[j][2 * h] + s[j][2 * h + 1];
                }
                l[h] = l[h] * corr + sum;
#pragma unroll
                for (int j = 0; j < DT; ++j) {
                    o[j][2 * h] *= corr;
                    o[j][2 * h + 1] *= corr;
                }
            }

            // O += P V: P rounded to bf16 is the A operand as it lies
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
                    load_b_kn<DV>(b, Vt, 16 * kk, 16 * np, lane);
                    mma_bf16(o[2 * np], a, b[0], b[1]);
                    mma_bf16(o[2 * np + 1], a, b[2], b[3]);
                }
            }
        }
        __syncthreads();                // this stage is free for reuse
    }

    if (!active) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = w0 + g + 8 * h;
        const float lsum = fmaxf(quad_sum(l[h]), 1e-30f);
        if (row >= n_rows) continue;
        const int i = row / G;
        const int head = kvh * G + row % G;
        const float inv = 1.f / lsum;
        bf16* og = static_cast<bf16*>(p.o) +
                   ((static_cast<long long>(bi) * p.sq + i) * p.H + head) * DV;
#pragma unroll
        for (int j = 0; j < DT; ++j)
            *reinterpret_cast<uint32_t*>(og + 8 * j + 2 * t) =
                pack_bf16(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
        if (t == 0)
            p.lse[(static_cast<long long>(bi) * p.H + head) * p.sq + i] =
                m[h] * 0.6931471805599453f + logf(lsum);
    }
}

template <int DK, int DV, int NW>
int launch_mma(const Params& p, cudaStream_t stream) {
    const size_t smem = mma_smem_bytes<DK, DV, NW>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<DK, DV, NW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int rows = p.sq * (p.H / p.KV);
    const dim3 grid((rows + 16 * NW - 1) / (16 * NW), p.KV, p.b);
    flash_fwd_mma_kernel<DK, DV, NW><<<grid, 32 * NW, smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

// one warp per block when all of a KV head's packed rows fit in 16
template <int DK, int DV>
int launch_mma_rows(const Params& p, cudaStream_t stream) {
    return p.sq * (p.H / p.KV) <= 16 ? launch_mma<DK, DV, 1>(p, stream)
                                     : launch_mma<DK, DV, 4>(p, stream);
}

// ---------------------------------------------------------------------------
// fp32: the PR 11 kernel on the FMA pipes

template <typename T, int DK, int DV>
int launch(const Params& p, cudaStream_t stream) {
    const size_t smem = smem_bytes<DK, DV>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DK, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((p.sq + BQ - 1) / BQ, p.H, p.b);
    flash_fwd_kernel<T, DK, DV><<<grid, NT, smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <int DK, int DV>
int launch_pair(const Params& p, bool mma, cudaStream_t stream) {
    return mma ? launch_mma_rows<DK, DV>(p, stream)
               : launch<float, DK, DV>(p, stream);
}

// the instantiated (q.k width, v width) pairs; any other is refused
int launch_dims(const Params& p, int dk, int dv, bool mma,
                cudaStream_t stream) {
    if (dk == 96 && dv == 64) return launch_pair<96, 64>(p, mma, stream);
    if (dk != dv) return static_cast<int>(cudaErrorInvalidValue);
    switch (dk) {
        case 16: return launch_pair<16, 16>(p, mma, stream);
        case 32: return launch_pair<32, 32>(p, mma, stream);
        case 64: return launch_pair<64, 64>(p, mma, stream);
        case 128: return launch_pair<128, 128>(p, mma, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

int run(bool mma, const void* q, const void* k, const void* v, void* o,
        void* lse, int dk, int dv, int b, int sq, int H, int KV,
        long long q_sb, long long q_ss, long long q_sh,
        long long k_sb, long long k_ss, long long k_sh,
        long long v_sb, long long v_ss, long long v_sh,
        int causal, int q_offset, int kv_len, float scale,
        const int* kv_lens, const int* pages, void* stream) {
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
    p.kv_lens = kv_lens;
    p.pages = pages;
    return launch_dims(p, dk, dv, mma, static_cast<cudaStream_t>(stream));
}

}  // namespace

namespace {

template <int DK, int DV>
long long pair_smem_bytes(int variant) {
    switch (variant) {
        case 0: return smem_bytes<DK, DV>();
        case 1: return mma_smem_bytes<DK, DV, 4>();
        case 2: return mma_smem_bytes<DK, DV, 1>();
        default: return -1;
    }
}

}  // namespace

// Dynamic shared memory of one block, or -1 for a variant or a (q.k
// width, v width) pair it does not have.  variant: 0 = fp32 FMA kernel,
// 1 = bf16 mma kernel with 4 warps (64 packed rows), 2 = bf16 mma kernel
// with 1 warp (16 rows).
extern "C" long long repro_flash_fwd_smem_bytes(int variant, int dk,
                                                int dv) {
    if (dk == 96 && dv == 64) return pair_smem_bytes<96, 64>(variant);
    if (dk != dv) return -1;
    switch (dk) {
        case 16: return pair_smem_bytes<16, 16>(variant);
        case 32: return pair_smem_bytes<32, 32>(variant);
        case 64: return pair_smem_bytes<64, 64>(variant);
        case 128: return pair_smem_bytes<128, 128>(variant);
        default: return -1;
    }
}

// Each returns a cudaError_t (0 on success); the launch is asynchronous
// on ``stream`` and does not synchronise.  Strides are in elements.
// repro_flash_fwd takes fp32 tensors (dtype 0), repro_flash_fwd_mma bf16
// (dtype 1) whose data pointers and strides are multiples of 16 bytes
// (cp.async); either refuses another dtype and an uninstantiated (dk, dv)
// pair (launch_dims).  kv_lens and pages are null,
// or int32 device arrays of b entries (a key count in [1, sk] and a page
// of k and v for each batch row; the caller checks the ranges), which
// then replace kv_len and the row's own batch index.
extern "C" int repro_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int dk, int dv, int b, int sq, int H, int KV,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int causal, int q_offset, int kv_len, float scale, const int* kv_lens,
    const int* pages, void* stream) {
    if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
    return run(false, q, k, v, o, lse, dk, dv, b, sq, H, KV, q_sb, q_ss,
               q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, q_offset,
               kv_len, scale, kv_lens, pages, stream);
}

extern "C" int repro_flash_fwd_mma(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int dk, int dv, int b, int sq, int H, int KV,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int causal, int q_offset, int kv_len, float scale, const int* kv_lens,
    const int* pages, void* stream) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    return run(true, q, k, v, o, lse, dk, dv, b, sq, H, KV, q_sb, q_ss,
               q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, q_offset,
               kv_len, scale, kv_lens, pages, stream);
}
