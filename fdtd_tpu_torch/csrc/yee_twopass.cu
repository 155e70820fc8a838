// Two-pass Yee leapfrog update for Hopper (sm_90a): the H half-step and the
// E half-step of a closed PEC cavity, each one kernel launch that updates
// all three components in place.  Vacuum takes scalar factors; the material
// variants take per-cell factors: the H pass three hf arrays (heterogeneous
// mu_r), the E pass six ca/cb arrays (lossy media, E = ca*E + cb*curl H).
//
// Replaces the TPU kernels fdtd_tpu/ops/pallas_fused.py::_h_kernel2 (H pass,
// vacuum and `het`) and ::_e_kernel2 (E pass, vacuum and `lossy`).  It works on the canonical uniform padded
// layout: six (K+1, J+1, I+1) arrays, i fastest, so the staggered bounds are
// the slice bounds of fdtd_tpu/ops/curl.py and there are no strips, no dead
// slab and no correction arrays.  The plain versions are
// fdtd_tpu_torch/ops/curl.py::update_h and ::update_e.
//
// Cost: each pass reads six fields and writes three, about 36 B per cell in
// fp32 (18 B in bf16) when the neighbour reads of the previous k plane and j
// row hit L2 or L1, so the pass is bound by device-memory bytes, not by
// arithmetic.  The material variants read their coefficient arrays once
// more per cell: 48 B (H, het) and 60 B (E, lossy) per cell in fp32.  This first version is one thread per cell, i on threadIdx.x so
// a warp reads consecutive addresses; it relies on the caches for the
// neighbour reads.  Rows of I+1 = 2^n + 1 elements are not 16-byte aligned,
// so a warp's access straddles an extra sector per row; padding i to a
// multiple of 4 or 8 is left to a later change.
//
// Numerics: fp32 storage computes in fp32; bf16 storage loads to fp32,
// computes in fp32 and rounds back with __float2bfloat16_rn.  Every operation
// is an explicitly rounded __fsub_rn/__fmul_rn/__fadd_rn in the order of
// ops/curl.py (lossy: ca*E + cb*curl, two products then the sum), and
// coefficients stored in bf16 widen to fp32 exactly, and the library is built with -fmad=false, so the result is
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

// (a1 - a0) - (b1 - b0), each operation rounded on its own
__device__ __forceinline__ float curl(float a1, float a0, float b1, float b0) {
    return __fsub_rn(__fsub_rn(a1, a0), __fsub_rn(b1, b0));
}

// h + f * curl
__device__ __forceinline__ float leap(float h, float f, float a1, float a0, float b1, float b0) {
    return __fadd_rn(h, __fmul_rn(f, curl(a1, a0, b1, b0)));
}

// ca * e + cb * curl (the lossy E update)
__device__ __forceinline__ float lossy(float e, float ca, float cb, float a1, float a0, float b1, float b0) {
    return __fadd_rn(__fmul_rn(ca, e), __fmul_rn(cb, curl(a1, a0, b1, b0)));
}

// the per-cell coefficient arrays of the material variants (unused in vacuum)
template <typename T>
struct Coefs {
    const T* a[3];  // E pass: ca_x, ca_y, ca_z; H pass: hf_x, hf_y, hf_z
    const T* b[3];  // E pass: cb_x, cb_y, cb_z
};

constexpr int BX = 64;  // threads along i
constexpr int BY = 4;   // threads along j

// H half-step over Hx k<K, j<J, i<=I; Hy k<K, j<=J, i<I; Hz k<=K, j<J, i<I.
// With has_patch, Hx and Hz at k=0, j0<=j<j1, i0<=i<i1 keep their values
// (the source hard-set there wins, reference main.c:770-778).  HET reads
// the factor of each component from hf.a[0..2] at the cell instead of f.
template <typename T, bool HET>
__global__ void __launch_bounds__(BX * BY)
h_kernel(const T* __restrict__ ex, const T* __restrict__ ey, const T* __restrict__ ez,
         T* __restrict__ hx, T* __restrict__ hy, T* __restrict__ hz,
         int K, int J, int I, float f,
         int has_patch, int j0, int j1, int i0, int i1, Coefs<T> hf) {
    const int i = blockIdx.x * BX + threadIdx.x;
    const int j = blockIdx.y * BY + threadIdx.y;
    const int k = blockIdx.z;
    if (i > I || j > J) return;
    const int64_t sj = (int64_t)I + 1;
    const int64_t sk = sj * ((int64_t)J + 1);
    const int64_t c = (int64_t)k * sk + (int64_t)j * sj + i;
    const bool in_patch = has_patch && k == 0 && j >= j0 && j < j1 && i >= i0 && i < i1;

    if (k < K && j < J && !in_patch) {
        const float fx = HET ? ld(hf.a[0], c) : f;
        st(hx, c, leap(ld(hx, c), fx, ld(ey, c + sk), ld(ey, c), ld(ez, c + sj), ld(ez, c)));
    }
    if (k < K && i < I) {
        const float fy = HET ? ld(hf.a[1], c) : f;
        st(hy, c, leap(ld(hy, c), fy, ld(ez, c + 1), ld(ez, c), ld(ex, c + sk), ld(ex, c)));
    }
    if (j < J && i < I && !in_patch) {
        const float fz = HET ? ld(hf.a[2], c) : f;
        st(hz, c, leap(ld(hz, c), fz, ld(ex, c + sj), ld(ex, c), ld(ey, c + 1), ld(ey, c)));
    }
}

// E half-step over the interior: Ex 1<=k<K, 1<=j<J, i<I; Ey 1<=k<K, j<J,
// 1<=i<I; Ez k<K, 1<=j<J, 1<=i<I.  Tangential E on the walls stays (PEC).
// LOSSY computes ca*E + cb*curl with ca = cf.a[c], cb = cf.b[c] at the cell.
template <typename T, bool LOSSY>
__global__ void __launch_bounds__(BX * BY)
e_kernel(const T* __restrict__ hx, const T* __restrict__ hy, const T* __restrict__ hz,
         T* __restrict__ ex, T* __restrict__ ey, T* __restrict__ ez,
         int K, int J, int I, float f, Coefs<T> cf) {
    const int i = blockIdx.x * BX + threadIdx.x;
    const int j = blockIdx.y * BY + threadIdx.y;
    const int k = blockIdx.z;
    if (i > I || j > J) return;
    const int64_t sj = (int64_t)I + 1;
    const int64_t sk = sj * ((int64_t)J + 1);
    const int64_t c = (int64_t)k * sk + (int64_t)j * sj + i;

    if (k >= 1 && k < K && j >= 1 && j < J && i < I) {
        const float a1 = ld(hz, c), a0 = ld(hz, c - sj), b1 = ld(hy, c), b0 = ld(hy, c - sk);
        st(ex, c, LOSSY ? lossy(ld(ex, c), ld(cf.a[0], c), ld(cf.b[0], c), a1, a0, b1, b0)
                        : leap(ld(ex, c), f, a1, a0, b1, b0));
    }
    if (k >= 1 && k < K && j < J && i >= 1 && i < I) {
        const float a1 = ld(hx, c), a0 = ld(hx, c - sk), b1 = ld(hz, c), b0 = ld(hz, c - 1);
        st(ey, c, LOSSY ? lossy(ld(ey, c), ld(cf.a[1], c), ld(cf.b[1], c), a1, a0, b1, b0)
                        : leap(ld(ey, c), f, a1, a0, b1, b0));
    }
    if (k < K && j >= 1 && j < J && i >= 1 && i < I) {
        const float a1 = ld(hy, c), a0 = ld(hy, c - 1), b1 = ld(hx, c), b0 = ld(hx, c - sj);
        st(ez, c, LOSSY ? lossy(ld(ez, c), ld(cf.a[2], c), ld(cf.b[2], c), a1, a0, b1, b0)
                        : leap(ld(ez, c), f, a1, a0, b1, b0));
    }
}

dim3 grid_for(int K, int J, int I) {
    return dim3((unsigned)((I + 1 + BX - 1) / BX), (unsigned)((J + 1 + BY - 1) / BY), (unsigned)(K + 1));
}

template <typename T, bool HET>
int launch_h(void* const* e, void* const* h, int K, int J, int I, float f, int has_patch,
             int j0, int j1, int i0, int i1, void* const* hf, cudaStream_t s) {
    Coefs<T> c{};
    if (HET)
        for (int q = 0; q < 3; ++q) c.a[q] = (const T*)hf[q];
    h_kernel<T, HET><<<grid_for(K, J, I), dim3(BX, BY), 0, s>>>(
        (const T*)e[0], (const T*)e[1], (const T*)e[2], (T*)h[0], (T*)h[1], (T*)h[2],
        K, J, I, f, has_patch, j0, j1, i0, i1, c);
    return (int)cudaGetLastError();
}

template <typename T, bool LOSSY>
int launch_e(void* const* h, void* const* e, int K, int J, int I, float f,
             void* const* cf, cudaStream_t s) {
    Coefs<T> c{};
    if (LOSSY)
        for (int q = 0; q < 3; ++q) {
            c.a[q] = (const T*)cf[q];
            c.b[q] = (const T*)cf[3 + q];
        }
    e_kernel<T, LOSSY><<<grid_for(K, J, I), dim3(BX, BY), 0, s>>>(
        (const T*)h[0], (const T*)h[1], (const T*)h[2], (T*)e[0], (T*)e[1], (T*)e[2],
        K, J, I, f, c);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Each entry point launches on `stream` and returns cudaGetLastError().
// e, h: three pointers each (x, y, z); coefficient arrays have the fields'
// shape and dtype.
extern "C" {

int yee_update_h(void* ex, void* ey, void* ez, void* hx, void* hy, void* hz,
                 int K, int J, int I, float f,
                 int has_patch, int j0, int j1, int i0, int i1,
                 int dtype, void* stream) {
    void* const e[3] = {ex, ey, ez};
    void* const h[3] = {hx, hy, hz};
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) return launch_h<float, false>(e, h, K, J, I, f, has_patch, j0, j1, i0, i1, nullptr, s);
    if (dtype == 1) return launch_h<__nv_bfloat16, false>(e, h, K, J, I, f, has_patch, j0, j1, i0, i1, nullptr, s);
    return (int)cudaErrorInvalidValue;
}

// hf: hf_x, hf_y, hf_z
int yee_update_h_het(void* const* e, void* const* h, void* const* hf, int K, int J, int I,
                     int has_patch, int j0, int j1, int i0, int i1, int dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) return launch_h<float, true>(e, h, K, J, I, 0.f, has_patch, j0, j1, i0, i1, hf, s);
    if (dtype == 1) return launch_h<__nv_bfloat16, true>(e, h, K, J, I, 0.f, has_patch, j0, j1, i0, i1, hf, s);
    return (int)cudaErrorInvalidValue;
}

int yee_update_e(void* hx, void* hy, void* hz, void* ex, void* ey, void* ez,
                 int K, int J, int I, float f, int dtype, void* stream) {
    void* const h[3] = {hx, hy, hz};
    void* const e[3] = {ex, ey, ez};
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) return launch_e<float, false>(h, e, K, J, I, f, nullptr, s);
    if (dtype == 1) return launch_e<__nv_bfloat16, false>(h, e, K, J, I, f, nullptr, s);
    return (int)cudaErrorInvalidValue;
}

// cf: ca_x, ca_y, ca_z, cb_x, cb_y, cb_z
int yee_update_e_lossy(void* const* h, void* const* e, void* const* cf, int K, int J, int I,
                       int dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) return launch_e<float, true>(h, e, K, J, I, 0.f, cf, s);
    if (dtype == 1) return launch_e<__nv_bfloat16, true>(h, e, K, J, I, 0.f, cf, s);
    return (int)cudaErrorInvalidValue;
}

const char* yee_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
