// Per-step DFT accumulation for Hopper (sm_90a): the E phasor sums of one
// step, added in place.
//
// Replaces the TPU kernel fdtd_tpu/ops/pallas_stream.py::
// build_dft_accum_call.kernel.  The plain version is
// fdtd_tpu_torch/ops/dft.py::plain_accumulate_e (fdtd_tpu_torch/dft.py::
// accumulate on diagnostics._e_cell_means).
//
// What it computes: for each cell (k, j, i) of the (K, J, I) cell grid the
// 4-edge cell means of the final E of a step, in the association of
// diagnostics._e_cell_means, 0.25 * (((a + b) + c) + d) in fp32 (bf16
// storage widens first), and for each frequency f
//
//     re[f][c][cell] = re[f][c][cell] + cw[f] * E_c
//     im[f][c][cell] = im[f][c][cell] - sw[f] * E_c
//
// for c = x, y, z, each product and sum rounded on its own (__f*_rn, built
// with -fmad=false), so the sums equal the plain torch version's bits.
// The sums are the canonical (nf, nc, K, J, I) fp32 pair (nc = 3, or 6
// with the H components, which this kernel leaves alone); the weights one
// (2, nf) fp32 row of the step, cos then sin, on the device.
//
// Design: one thread per cell, i fastest, reading the 12 E edges it needs
// (neighbouring threads share them through L1/L2) and looping over nf, a
// runtime value: the kernel has no limit on the number of frequencies.
// Offsets are 64-bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float ld(const float* p, int64_t o) { return p[o]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int64_t o) { return __bfloat162float(p[o]); }

__device__ __forceinline__ float mean4(float a, float b, float c, float d) {
    return __fmul_rn(0.25f, __fadd_rn(__fadd_rn(__fadd_rn(a, b), c), d));
}

template <typename T>
__global__ void __launch_bounds__(256)
dft_accum_kernel(const T* __restrict__ ex, const T* __restrict__ ey, const T* __restrict__ ez, int K, int J,
                 int I, const float* __restrict__ w, int nf, int nc, float* __restrict__ re,
                 float* __restrict__ im) {
    const int64_t cells = (int64_t)K * J * I;
    const int64_t cell = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (cell >= cells) return;
    const int i = (int)(cell % I);
    const int j = (int)((cell / I) % J);
    const int k = (int)(cell / ((int64_t)I * J));
    const int64_t sj = (int64_t)I + 1;
    const int64_t sk = sj * ((int64_t)J + 1);
    const int64_t o = (int64_t)k * sk + (int64_t)j * sj + i;
    const float mx = mean4(ld(ex, o), ld(ex, o + sk), ld(ex, o + sj), ld(ex, o + sk + sj));
    const float my = mean4(ld(ey, o), ld(ey, o + 1), ld(ey, o + sk), ld(ey, o + sk + 1));
    const float mz = mean4(ld(ez, o), ld(ez, o + sj), ld(ez, o + 1), ld(ez, o + sj + 1));
    const float m[3] = {mx, my, mz};
    for (int f = 0; f < nf; ++f) {
        const float cw = __ldg(w + f), sw = __ldg(w + nf + f);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const int64_t a = ((int64_t)f * nc + c) * cells + cell;
            re[a] = __fadd_rn(re[a], __fmul_rn(cw, m[c]));
            im[a] = __fsub_rn(im[a], __fmul_rn(sw, m[c]));
        }
    }
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// e: three pointers (ex, ey, ez), each (K+1, J+1, I+1) in the storage dtype;
// w: 2*nf fp32 (cos, then sin); re, im: (nf, nc, K, J, I) fp32, updated in
// place.  Launches on `stream` and returns cudaGetLastError().
extern "C" {

int dft_accum(void* const* e, int K, int J, int I, const void* w, int nf, int nc, void* re, void* im,
              int dtype, void* stream) {
    if (K < 1 || J < 1 || I < 1 || nf < 1 || nc < 3 || w == nullptr || re == nullptr || im == nullptr)
        return (int)cudaErrorInvalidValue;
    const int64_t cells = (int64_t)K * J * I;
    const unsigned blocks = (unsigned)((cells + 255) / 256);
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0)
        dft_accum_kernel<float><<<blocks, 256, 0, st>>>((const float*)e[0], (const float*)e[1], (const float*)e[2],
                                                        K, J, I, (const float*)w, nf, nc, (float*)re, (float*)im);
    else if (dtype == 1)
        dft_accum_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
            (const __nv_bfloat16*)e[0], (const __nv_bfloat16*)e[1], (const __nv_bfloat16*)e[2], K, J, I,
            (const float*)w, nf, nc, (float*)re, (float*)im);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

const char* dft_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
