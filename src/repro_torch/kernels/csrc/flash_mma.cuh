// Tensor-core helpers shared by the bf16 flash kernels (flash_fwd.cu's
// flash_fwd_mma_kernel, flash_bwd.cu's flash_bwd_dq_mma_kernel and
// flash_bwd_dkv_mma_kernel), for Hopper (sm_90a) through the Ampere-style
// warp-level instructions:
//
//   * mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: one warp
//     multiplies a 16 x 16 bf16 A fragment by a 16 x 8 bf16 B fragment
//     into a 16 x 8 fp32 accumulator;
//   * ldmatrix (.x4, and .trans for a B operand stored along its k axis):
//     four 8 x 8 bf16 matrices from shared memory into fragments;
//   * 16-byte cp.async.cg with zero fill (src-size 0) for rows past the
//     sequence, 4-byte cp.async.ca for per-row fp32 gathers, plus commit
//     and wait;
//   * the quad reductions of a row held by the four lanes of a quad.
//
// Fragment layout (PTX ISA, "Matrix Fragments for mma.m16n8k16"): lane
// l is in group g = l / 4 at position t = l % 4.  A (16 x 16, row-major):
// a[0] = (row g, cols 2t, 2t+1), a[1] = (row g+8, cols 2t..), a[2] =
// (row g, cols 2t+8..), a[3] = (row g+8, cols 2t+8..).  B (16 x 8, k by
// n): b[0] = (k 2t, 2t+1; col g), b[1] = (k 2t+8, 2t+9; col g).  The
// accumulator: c[0], c[1] = (row g, cols 2t, 2t+1), c[2], c[3] = (row
// g+8, cols 2t, 2t+1).  So a row's values sit in the four lanes of one
// quad, and an accumulator of a 16 x 16 block rounded to bf16 is already
// the A fragment of the next product (FlashAttention-2's register reuse).
//
// Shared-memory layout: a tile of rows x D bf16 is stored row-major with
// a row stride of D + 8 elements (16 bytes of padding per row), D / 2 + 4
// banks, an odd multiple of 4 for every D that is a multiple of 16.
// ldmatrix reads eight 16-byte rows per 8 x 8 matrix; with that stride the
// eight rows fall in eight distinct 4-bank groups at every D in {16, 32,
// 64, 96, 128}: no bank conflict, and no swizzle arithmetic on the
// addresses.  Each helper takes its tile's width D: the kernels pass the
// q.k width DK for Q and K tiles and the v width DV for V and dO tiles,
// which differ for multi-head latent attention (96 and 64).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace flash_mma {

typedef __nv_bfloat16 bf16;

constexpr int PAD = 8;          // bf16 of padding per shared row

template <int D>
__host__ __device__ constexpr int row_stride() { return D + PAD; }

// bytes of one [rows][D + PAD] bf16 tile in shared memory
template <int D>
__host__ __device__ constexpr int tile_bytes(int rows) {
    return rows * row_stride<D>() * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
// (src-size 0 reads nothing, so src need only be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                 "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
                 "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
        "{%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
}

// c += a (16 x 16 bf16) * b (16 x 8 bf16), fp32 accumulate
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 -> one register of two bf16, lo in the low half (the lower
// column of an mma fragment)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment of rows [row0, row0 + 16) x cols [k0, k0 + 16) of a
// row-major tile (Q or dO)
template <int D>
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* tile,
                                       int row0, int k0, int lane) {
    ldmatrix_x4(a, tile + (row0 + (lane & 15)) * row_stride<D>() + k0 +
                       (lane >> 4) * 8);
}

// B fragments of two n-tiles when the tile stores B transposed, n along
// rows and k along columns (K in Q K^T, V in dO V^T): rows [n0, n0 + 16)
// x cols [k0, k0 + 16).  b[0], b[1] serve n-tile n0 / 8; b[2], b[3]
// n-tile n0 / 8 + 1.
template <int D>
__device__ __forceinline__ void load_b_nk(uint32_t b[4], const bf16* tile,
                                          int n0, int k0, int lane) {
    ldmatrix_x4(b, tile + (n0 + (lane & 7) + (lane >> 4) * 8) *
                       row_stride<D>() + k0 + ((lane >> 3) & 1) * 8);
}

// B fragments of two n-tiles when the tile stores B as is, k along rows
// and n along columns (V in P V, K in dS K): rows [k0, k0 + 16) x cols
// [n0, n0 + 16), through ldmatrix.trans.  b[0], b[1] serve n-tile n0 / 8;
// b[2], b[3] n-tile n0 / 8 + 1.
template <int D>
__device__ __forceinline__ void load_b_kn(uint32_t b[4], const bf16* tile,
                                          int k0, int n0, int lane) {
    ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                             row_stride<D>() + n0 + (lane >> 4) * 8);
}

// rows [row0, row0 + ROWS) of a strided [seq, D] slice into a tile,
// zero past `limit`; NT threads share the copies
template <int D, int NT, int ROWS>
__device__ __forceinline__ void load_rows(bf16* tile, const bf16* src,
                                          long long stride, int row0,
                                          int limit, int tid) {
    constexpr int CPR = D / 8;          // 16-byte chunks per row
    for (int c = tid; c < ROWS * CPR; c += NT) {
        const int r = c / CPR, ch = c % CPR;
        const int row = row0 + r;
        const bool ok = row < limit;
        cp_async16(tile + r * row_stride<D>() + ch * 8,
                   ok ? src + row * stride + ch * 8 : src, ok);
    }
}

// packed rows [r0, r0 + BM) into a tile: packed row R is query R / G of
// head R % G of the group whose first head `src` points at (query-major,
// so the G heads of one query are adjacent), zero past `n_rows` = sq * G
template <int D, int NT, int BM>
__device__ __forceinline__ void load_packed(bf16* tile, const bf16* src,
                                            long long s_stride,
                                            long long h_stride, int G,
                                            int r0, int n_rows, int tid) {
    constexpr int CPR = D / 8;
    for (int c = tid; c < BM * CPR; c += NT) {
        const int r = c / CPR, ch = c % CPR;
        const int row = r0 + r;
        const bool ok = row < n_rows;
        const bf16* p = ok ? src + (row / G) * s_stride +
                                 (row % G) * h_stride + ch * 8
                           : src;
        cp_async16(tile + r * row_stride<D>() + ch * 8, p, ok);
    }
}

// one fp32 value per packed row [r0, r0 + BM) of a [heads, sq] array
// (lse or dl) whose group's first head `src` points at: packed row R
// reads head R % G, query R / G; zero past `n_rows`
template <int NT, int BM>
__device__ __forceinline__ void load_packed_f32(float* dst, const float* src,
                                                int sq, int G, int r0,
                                                int n_rows, int tid) {
    for (int c = tid; c < BM; c += NT) {
        const int row = r0 + c;
        const bool ok = row < n_rows;
        cp_async4(dst + c, ok ? src + (row % G) * sq + row / G : src, ok);
    }
}

// max and sum over the four lanes of a quad (one accumulator row)
__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace flash_mma
