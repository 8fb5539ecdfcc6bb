// TF32 tensor-core helpers shared by the chunked scan kernels
// (rwkv6_scan.cu's wkv_chunk_kernel, mamba2_scan.cu's ssd_chunk_kernel),
// for Hopper (sm_90a) through the Ampere-style warp-level instruction
//
//   mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32
//
// one warp multiplying a 16 x 8 TF32 A fragment by an 8 x 8 TF32 B
// fragment into a 16 x 8 fp32 accumulator.
//
// Fragment layout (PTX ISA, "Matrix Fragments for mma.m16n8k8", .tf32):
// lane l is in group g = l / 4 at position t = l % 4.  A (16 x 8): a[0] =
// (row g, col t), a[1] = (row g+8, col t), a[2] = (row g, col t+4), a[3] =
// (row g+8, col t+4).  B (8 x 8, k by n): b[0] = (k t, col g), b[1] = (k
// t+4, col g).  The accumulator: c[0], c[1] = (row g, cols 2t, 2t+1),
// c[2], c[3] = (row g+8, cols 2t, 2t+1).  An accumulator is made the A
// operand of a further product without moving data by permuting the k
// axis of that product: A's k slot t takes the accumulator's column 2t
// and slot t+4 column 2t+1 (a = {c[0], c[2], c[1], c[3]}), and the B
// operand is read at the same permuted k (rows 2t and 2t+1).
//
// fp32 accuracy from TF32 (10 mantissa bits, about three digits): each
// fp32 operand x is split as x = hi + lo, hi = x rounded to the nearest
// TF32 value (ties away from zero, as cvt.rna.tf32.f32 rounds) and lo =
// x - hi (exact in fp32), of which the tensor core reads the TF32 part
// (it ignores an operand's 13 low mantissa bits); a product is then
// a_hi b_hi + a_hi b_lo + a_lo b_hi ("3xTF32"), the two small products
// first; the dropped a_lo b_lo is ~2^-22 of the product.  The rounding
// is two integer operations on the bits rather than cvt.rna.tf32.f32,
// which runs on the conversion pipe at a fraction of the FP32 rate (the
// kernels split every fp32-derived fragment they load).  An operand that
// is already exact in TF32 (a bf16 value: 8 mantissa bits) has lo = 0,
// so its products take two mma's, or one when both operands are exact.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_mma.cuh"   // cp.async helpers

namespace scan_mma {

using flash_mma::cp_async16;
using flash_mma::cp_async4;
using flash_mma::cp_async_commit;
using flash_mma::cp_async_wait;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

// x rounded to the nearest TF32 value, ties away from zero: half a TF32
// unit added to the magnitude bits, then the 13 low bits cleared
__device__ __forceinline__ uint32_t tf32(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// A 3xTF32 operand: the high and low TF32 parts of each fp32 element
template <int K>
struct Frag {
    uint32_t hi[K];
    uint32_t lo[K];
};

// split fp32 values into TF32 parts (lo as its fp32 bits: the tensor
// core reads their TF32 part); EXACT: the values are exact in TF32
// already (hi is x itself, lo stays unset and unused)
template <bool EXACT, int K>
__device__ __forceinline__ void split(Frag<K>& f, const float (&x)[K]) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
        f.hi[i] = EXACT ? __float_as_uint(x[i]) : tf32(x[i]);
        if (!EXACT)
            f.lo[i] = __float_as_uint(x[i] - __uint_as_float(f.hi[i]));
    }
}

// d += a b, one TF32 mma.sync (no side effects: the compiler may
// interleave independent ones)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t* a,
                                         const uint32_t* b) {
    asm(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
}

// d += a b to fp32 accuracy: a_lo b_hi and a_hi b_lo (each only where
// that operand is not exact in TF32), then a_hi b_hi
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4>& a,
                                     const Frag<2>& b) {
    if (!A_EXACT) mma_tf32(d, a.lo, b.hi);
    if (!B_EXACT) mma_tf32(d, a.hi, b.lo);
    mma_tf32(d, a.hi, b.hi);
}

// One warp's share of C += A B (the scans' backward kernels): the 16 rows
// r0.. and NB column tiles of 8 from c0, over k in [k0, k1) (multiples of
// 8), each operand read as fp32 through a(row, k) and b(k, col) (from
// shared memory, transposed or scaled as the caller's lambda says) and
// split 3xTF32 unless it is exact in TF32 (AEX, BEX: bf16 values).
// acc[nb][e] is (row r0 + g + 8 (e / 2), column c0 + 8 nb + 2 t + e % 2)
// for lane 4 g + t.  Even and odd k steps go to two accumulators (two
// independent mma chains), added at the end.
template <bool AEX, bool BEX, int NB, class FA, class FB>
__device__ __forceinline__ void warp_mma(float (&acc)[NB][4], int r0,
                                         int c0, int k0, int k1, FA a,
                                         FB b) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    float odd[NB][4] = {};
    auto step = [&](float (&d)[NB][4], int kk) {
        const float av[4] = {a(r0 + g, kk + t), a(r0 + g + 8, kk + t),
                             a(r0 + g, kk + t + 4),
                             a(r0 + g + 8, kk + t + 4)};
        Frag<4> fa;
        split<AEX>(fa, av);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
            const float bv[2] = {b(kk + t, c0 + 8 * nb + g),
                                 b(kk + t + 4, c0 + 8 * nb + g)};
            Frag<2> fb;
            split<BEX>(fb, bv);
            mma3<AEX, BEX>(d[nb], fa, fb);
        }
    };
    for (int kk = k0; kk < k1; kk += 16) {
        step(acc, kk);
        if (kk + 8 < k1) step(odd, kk + 8);
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nb][e] += odd[nb][e];
}

// fn(row, column, element) over a warp_mma accumulator, or (row, column)
// -> the element's new value with acc_set
template <int NB, class Fn>
__device__ __forceinline__ void acc_each(float (&acc)[NB][4], int r0,
                                         int c0, Fn fn) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            fn(r0 + g + 8 * (e >> 1), c0 + 8 * nb + 2 * t + (e & 1),
               acc[nb][e]);
}

template <int NB, class Fn>
__device__ __forceinline__ void acc_set(float (&acc)[NB][4], int r0, int c0,
                                        Fn fn) {
    acc_each(acc, r0, c0, [&](int r, int c, float& x) { x = fn(r, c); });
}

// The sum over the 4 lanes of a quad (the lanes holding one row of a
// warp_mma accumulator), in a fixed order
__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// out[row] = the sum over a warp_mma accumulator's columns of f(row, col)
// times the element, one per row of the warp's 16 (written by the row's
// first lane; the lanes' parts added in a fixed order)
template <int NB, class Fn>
__device__ __forceinline__ void row_sums(float (&acc)[NB][4], int r0,
                                         int c0, Fn f, float* out) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int c = c0 + 8 * nb + 2 * t + (e & 1);
            if (e < 2)
                s0 = fmaf(f(r0 + g, c), acc[nb][e], s0);
            else
                s1 = fmaf(f(r0 + g + 8, c), acc[nb][e], s1);
        }
    s0 = quad_sum(s0);
    s1 = quad_sum(s1);
    if (t == 0) {
        out[r0 + g] = s0;
        out[r0 + g + 8] = s1;
    }
}

// One stage of half_warp_scatter_sum: x[0..2 OFF) -> x[0..OFF), the half
// this lane keeps plus its partner's (lane ^ OFF) other half
template <int OFF>
__device__ __forceinline__ void scatter_stage(float (&x)[16], int l) {
    const bool up = l & OFF;
#pragma unroll
    for (int i = 0; i < OFF; ++i) {
        const float send = up ? x[i] : x[i + OFF];
        const float keep = up ? x[i + OFF] : x[i];
        x[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
}

// Reduce-scatter over the 16 lanes of a half warp: lane l (of the 16)
// returns the sum over the 16 lanes of their x[l], in a fixed order (15
// shuffles: halves exchanged at lane distances 8, 4, 2, 1); x is consumed.
__device__ __forceinline__ float half_warp_scatter_sum(float (&x)[16]) {
    const int l = threadIdx.x & 15;
    scatter_stage<8>(x, l);
    scatter_stage<4>(x, l);
    scatter_stage<2>(x, l);
    scatter_stage<1>(x, l);
    return x[0];
}

// n consecutive elements (n = 1, 2 or 4; 4 n-byte aligned for fp32, 2 n
// for bf16) as fp32, in one shared-memory load
template <int NV>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[NV]) {
    if constexpr (NV == 4) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } else if constexpr (NV == 2) {
        const float2 v = *reinterpret_cast<const float2*>(p);
        x[0] = v.x; x[1] = v.y;
    } else {
        x[0] = *p;
    }
}
template <int NV>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&x)[NV]) {
    if constexpr (NV == 4) {
        const uint2 u = *reinterpret_cast<const uint2*>(p);
        const float2 lo = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 hi = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u.y));
        x[0] = lo.x; x[1] = lo.y; x[2] = hi.x; x[3] = hi.y;
    } else if constexpr (NV == 2) {
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p));
        x[0] = v.x; x[1] = v.y;
    } else {
        x[0] = __bfloat162float(*p);
    }
}

// Products over the 64 values x_j of two warps (lane j % 32 of warp j /
// 32 holding x_j), by a scan of products (no quotient): the inclusive
// prefix prod_{m<=j} x_m (SUFFIX false) or suffix prod_{m>=j} x_m.  tot
// is a 2-float scratch in shared memory; every thread of the block calls
// it (the two warps of the scan are warps 0 and 1).
template <bool SUFFIX>
__device__ __forceinline__ float scan_prod64(float x, float* tot) {
    const int tid = threadIdx.x, lane = tid & 31;
    if (tid < 64) {
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float y = SUFFIX ? __shfl_down_sync(0xffffffffu, x, off)
                                   : __shfl_up_sync(0xffffffffu, x, off);
            if (SUFFIX ? lane + off < 32 : lane >= off) x *= y;
        }
        if (SUFFIX ? lane == 0 : lane == 31) tot[tid >> 5] = x;
    }
    __syncthreads();
    if (tid < 64 && (SUFFIX ? tid < 32 : tid >= 32)) x *= tot[SUFFIX ? 1 : 0];
    return x;
}

// The jobs of an [M x N] product shared by a block's NW warps: 16 rows by
// 8 NB columns each, fn(r0, c0) for this warp's
template <int M, int N, int NB, int NW, class Fn>
__device__ __forceinline__ void warp_jobs(int warp, Fn fn) {
    constexpr int CJ = N / (8 * NB);
    static_assert(M % 16 == 0 && N % (8 * NB) == 0, "job tiling");
    for (int j = warp; j < (M / 16) * CJ; j += NW)
        fn(16 * (j / CJ), 8 * NB * (j % CJ));
}

}  // namespace scan_mma
