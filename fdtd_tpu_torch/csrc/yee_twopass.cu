// Two-pass Yee leapfrog update for Hopper (sm_90a): the H half-step and the
// E half-step of a closed PEC cavity in vacuum, each one kernel launch that
// updates all three components in place.
//
// Replaces the TPU kernels fdtd_tpu/ops/pallas_fused.py::_h_kernel2 (H pass)
// and ::_e_kernel2 (E pass).  It works on the canonical uniform padded
// layout: six (K+1, J+1, I+1) arrays, i fastest, so the staggered bounds are
// the slice bounds of fdtd_tpu/ops/curl.py and there are no strips, no dead
// slab and no correction arrays.  The plain versions are
// fdtd_tpu_torch/ops/curl.py::update_h and ::update_e.
//
// Cost: each pass reads six fields and writes three, about 36 B per cell in
// fp32 (18 B in bf16) when the neighbour reads of the previous k plane and j
// row hit L2 or L1, so the pass is bound by device-memory bytes, not by
// arithmetic.  This first version is one thread per cell, i on threadIdx.x so
// a warp reads consecutive addresses; it relies on the caches for the
// neighbour reads.  Rows of I+1 = 2^n + 1 elements are not 16-byte aligned,
// so a warp's access straddles an extra sector per row; padding i to a
// multiple of 4 or 8 is left to a later change.
//
// Numerics: fp32 storage computes in fp32; bf16 storage loads to fp32,
// computes in fp32 and rounds back with __float2bfloat16_rn.  Every operation
// is an explicitly rounded __fsub_rn/__fmul_rn/__fadd_rn in the order of
// ops/curl.py, and the library is built with -fmad=false, so the result is
// bit-equal to the plain version on the same card.  Offsets are 64-bit:
// a 1025^3 array has more than 2^31 elements.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float ld(const float* p, int64_t o) { return p[o]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int64_t o) { return __bfloat162float(p[o]); }
__device__ __forceinline__ void st(float* p, int64_t o, float v) { p[o] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, int64_t o, float v) { p[o] = __float2bfloat16_rn(v); }

// h + f * ((a1 - a0) - (b1 - b0)), each operation rounded on its own
__device__ __forceinline__ float leap(float h, float f, float a1, float a0, float b1, float b0) {
    return __fadd_rn(h, __fmul_rn(f, __fsub_rn(__fsub_rn(a1, a0), __fsub_rn(b1, b0))));
}

constexpr int BX = 64;  // threads along i
constexpr int BY = 4;   // threads along j

// H half-step over Hx k<K, j<J, i<=I; Hy k<K, j<=J, i<I; Hz k<=K, j<J, i<I.
// With has_patch, Hx and Hz at k=0, j0<=j<j1, i0<=i<i1 keep their values
// (the source hard-set there wins, reference main.c:770-778).
template <typename T>
__global__ void __launch_bounds__(BX * BY)
h_kernel(const T* __restrict__ ex, const T* __restrict__ ey, const T* __restrict__ ez,
         T* __restrict__ hx, T* __restrict__ hy, T* __restrict__ hz,
         int K, int J, int I, float f,
         int has_patch, int j0, int j1, int i0, int i1) {
    const int i = blockIdx.x * BX + threadIdx.x;
    const int j = blockIdx.y * BY + threadIdx.y;
    const int k = blockIdx.z;
    if (i > I || j > J) return;
    const int64_t sj = (int64_t)I + 1;
    const int64_t sk = sj * ((int64_t)J + 1);
    const int64_t c = (int64_t)k * sk + (int64_t)j * sj + i;
    const bool in_patch = has_patch && k == 0 && j >= j0 && j < j1 && i >= i0 && i < i1;

    if (k < K && j < J && !in_patch) {
        st(hx, c, leap(ld(hx, c), f, ld(ey, c + sk), ld(ey, c), ld(ez, c + sj), ld(ez, c)));
    }
    if (k < K && i < I) {
        st(hy, c, leap(ld(hy, c), f, ld(ez, c + 1), ld(ez, c), ld(ex, c + sk), ld(ex, c)));
    }
    if (j < J && i < I && !in_patch) {
        st(hz, c, leap(ld(hz, c), f, ld(ex, c + sj), ld(ex, c), ld(ey, c + 1), ld(ey, c)));
    }
}

// E half-step over the interior: Ex 1<=k<K, 1<=j<J, i<I; Ey 1<=k<K, j<J,
// 1<=i<I; Ez k<K, 1<=j<J, 1<=i<I.  Tangential E on the walls stays (PEC).
template <typename T>
__global__ void __launch_bounds__(BX * BY)
e_kernel(const T* __restrict__ hx, const T* __restrict__ hy, const T* __restrict__ hz,
         T* __restrict__ ex, T* __restrict__ ey, T* __restrict__ ez,
         int K, int J, int I, float f) {
    const int i = blockIdx.x * BX + threadIdx.x;
    const int j = blockIdx.y * BY + threadIdx.y;
    const int k = blockIdx.z;
    if (i > I || j > J) return;
    const int64_t sj = (int64_t)I + 1;
    const int64_t sk = sj * ((int64_t)J + 1);
    const int64_t c = (int64_t)k * sk + (int64_t)j * sj + i;

    if (k >= 1 && k < K && j >= 1 && j < J && i < I) {
        st(ex, c, leap(ld(ex, c), f, ld(hz, c), ld(hz, c - sj), ld(hy, c), ld(hy, c - sk)));
    }
    if (k >= 1 && k < K && j < J && i >= 1 && i < I) {
        st(ey, c, leap(ld(ey, c), f, ld(hx, c), ld(hx, c - sk), ld(hz, c), ld(hz, c - 1)));
    }
    if (k < K && j >= 1 && j < J && i >= 1 && i < I) {
        st(ez, c, leap(ld(ez, c), f, ld(hy, c), ld(hy, c - 1), ld(hx, c), ld(hx, c - sj)));
    }
}

dim3 grid_for(int K, int J, int I) {
    return dim3((unsigned)((I + 1 + BX - 1) / BX), (unsigned)((J + 1 + BY - 1) / BY), (unsigned)(K + 1));
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Each entry point launches on `stream` and returns cudaGetLastError().
extern "C" {

int yee_update_h(void* ex, void* ey, void* ez, void* hx, void* hy, void* hz,
                 int K, int J, int I, float f,
                 int has_patch, int j0, int j1, int i0, int i1,
                 int dtype, void* stream) {
    const dim3 block(BX, BY);
    const dim3 grid = grid_for(K, J, I);
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) {
        h_kernel<float><<<grid, block, 0, s>>>(
            (const float*)ex, (const float*)ey, (const float*)ez,
            (float*)hx, (float*)hy, (float*)hz, K, J, I, f, has_patch, j0, j1, i0, i1);
    } else if (dtype == 1) {
        h_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
            (const __nv_bfloat16*)ex, (const __nv_bfloat16*)ey, (const __nv_bfloat16*)ez,
            (__nv_bfloat16*)hx, (__nv_bfloat16*)hy, (__nv_bfloat16*)hz,
            K, J, I, f, has_patch, j0, j1, i0, i1);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

int yee_update_e(void* hx, void* hy, void* hz, void* ex, void* ey, void* ez,
                 int K, int J, int I, float f, int dtype, void* stream) {
    const dim3 block(BX, BY);
    const dim3 grid = grid_for(K, J, I);
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) {
        e_kernel<float><<<grid, block, 0, s>>>(
            (const float*)hx, (const float*)hy, (const float*)hz,
            (float*)ex, (float*)ey, (float*)ez, K, J, I, f);
    } else if (dtype == 1) {
        e_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
            (const __nv_bfloat16*)hx, (const __nv_bfloat16*)hy, (const __nv_bfloat16*)hz,
            (__nv_bfloat16*)ex, (__nv_bfloat16*)ey, (__nv_bfloat16*)ez, K, J, I, f);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

const char* yee_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
