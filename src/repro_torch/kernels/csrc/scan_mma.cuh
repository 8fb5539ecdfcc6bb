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

}  // namespace scan_mma
