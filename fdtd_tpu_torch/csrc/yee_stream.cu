// Streaming multi-step Yee sweep for Hopper (sm_90a): one launch advances a
// closed PEC cavity in vacuum by S in {8, 4, 2} leapfrog steps.
//
// Replaces the TPU kernel fdtd_tpu/ops/pallas_stream.py::_kernel (vacuum,
// single device, both modes).  The plain version is
// fdtd_tpu_torch/ops/stream.py::plain_sweep; the plan (tile and block
// counts) is fdtd_tpu_torch/ops/stream_plan.py.
//
// What it computes: exactly S steps of the two-pass kernels
// (yee_twopass.cu), with every level in fp32.  Layout: six canonical
// (K+1, J+1, I+1) arrays, i fastest.  The source (computation mode): the
// caller hard-sets step 1 on the input state; for steps m >= 2 the drive
// rows ez_rows[m-2], hx_rows[m-2] replace Ez/Hx (and zero Ex/Hz) on the k=0
// patch in the INPUTS of level m only, as the TPU kernel does (:420-433),
// and H never updates Hx/Hz on that patch.
//
// Design.  A block owns a (j, i) column tile of BJ x BI threads, one
// column per thread, and marches a segment of k planes as a skewed
// pipeline: at pipeline step r, level m (the state after m steps) updates
// plane r - m, levels in increasing order.  Level m's H on plane k needs
// level m-1's E on planes k and k+1; its E needs its own H on planes k and
// k-1.  So a thread keeps, per level, the newest plane of its column in
// registers (6 fp32 values; level S keeps only H), and k never needs a
// halo: the pipeline carries it.  The neighbour reads along j and i go
// through one shared (j, i) plane of E and one of H, written and read once
// per level (two __syncthreads per level).  Validity shrinks by one column
// per side per level (H reads +1 in j and i, E reads -1), so the block
// emits level S on its interior (BJ - 2S) x (BI - 2S) columns; the rest is
// a recompute halo.  A k segment [k0, k1) starts its pipeline at k0 - S
// (a recomputed lead-in) and is an independent block, so a sweep has
// enough blocks for 132 SMs.
//
// Blocks run concurrently, so a sweep cannot update in place (a block's
// interior writes would be read by a neighbour's halo): it reads one state
// and writes a second.
//
// Cost: the sweep reads each field once per halo-amplified tile and writes
// it once: 48 B per cell per S steps in fp32 before amplification (24 B in
// bf16), against 72 B per step for the two-pass kernels.  This first
// version loads and stores with plain per-thread accesses (no TMA, no
// cp.async) and synchronises the block twice per level and plane.
//
// Numerics: every operation is an explicitly rounded __fsub_rn / __fmul_rn /
// __fadd_rn in the order of ops/curl.py, built with -fmad=false, so fp32 is
// bit-equal to S steps of the two-pass kernels and of the plain torch
// steps.  bf16 storage loads to fp32, keeps every level in fp32 and rounds
// once per sweep, at the store.  Offsets are 64-bit.

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

constexpr int BI = 32;  // threads along i: one warp

template <typename T>
struct Fields {
    const T* ex; const T* ey; const T* ez; const T* hx; const T* hy; const T* hz;
};

template <typename T>
struct OutFields {
    T* ex; T* ey; T* ez; T* hx; T* hy; T* hz;
};

template <typename T, int S, int BJ>
__global__ void __launch_bounds__(BI * BJ, 1)
stream_kernel(Fields<T> in, OutFields<T> out, int K, int J, int I, float fh, float fe,
              int tk, int has_patch, int j0, int j1, int i0, int i1,
              const T* __restrict__ ez_rows, const T* __restrict__ hx_rows) {
    constexpr int TJ = BJ - 2 * S;
    constexpr int TI = BI - 2 * S;
    __shared__ float sE[3][BJ][BI];
    __shared__ float sH[3][BJ][BI];

    const int tx = threadIdx.x, ty = threadIdx.y;
    const int i = (int)blockIdx.x * TI - S + tx;
    const int j = (int)blockIdx.y * TJ - S + ty;
    const int k0 = (int)blockIdx.z * tk;
    const int k1 = min(k0 + tk, K + 1);
    const int ks = max(k0 - S, 0);

    const int64_t sj = (int64_t)I + 1;
    const int64_t sk = sj * ((int64_t)J + 1);
    const bool inbox = i >= 0 && i <= I && j >= 0 && j <= J;
    const int64_t col = inbox ? (int64_t)j * sj + i : 0;
    const bool emit = inbox && tx >= S && tx < S + TI && ty >= S && ty < S + TJ;

    // per-column update bounds (yee_twopass.cu's, without k)
    const bool c_hx = inbox && j < J;
    const bool c_hy = inbox && i < I;
    const bool c_hz = inbox && j < J && i < I;
    const bool c_ex = inbox && j >= 1 && j < J && i < I;
    const bool c_ey = inbox && j < J && i >= 1 && i < I;
    const bool c_ez = inbox && j >= 1 && j < J && i >= 1 && i < I;
    const bool c_patch = has_patch && inbox && j >= j0 && j < j1 && i >= i0 && i < i1;
    const int ni = i1 - i0;

    // e[m], h[m]: level m's newest plane of this column (level S: H only)
    float e[S][3], h[S + 1][3];
#pragma unroll
    for (int m = 0; m <= S; ++m) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            if (m < S) e[m][c] = 0.f;
            h[m][c] = 0.f;
        }
    }

    for (int r = ks; r <= k1 - 1 + S; ++r) {
        // eo, ho: the inputs of the next level, i.e. the previous level's
        // plane before this pipeline step replaced it
        float eo[3] = {e[0][0], e[0][1], e[0][2]};
        float ho[3] = {h[0][0], h[0][1], h[0][2]};
        if (inbox && r <= K) {
            const int64_t o = (int64_t)r * sk + col;
            e[0][0] = ld(in.ex, o); e[0][1] = ld(in.ey, o); e[0][2] = ld(in.ez, o);
            h[0][0] = ld(in.hx, o); h[0][1] = ld(in.hy, o); h[0][2] = ld(in.hz, o);
        } else {
#pragma unroll
            for (int c = 0; c < 3; ++c) { e[0][c] = 0.f; h[0][c] = 0.f; }
        }

#pragma unroll
        for (int m = 1; m <= S; ++m) {
            const int k = r - m;
            const bool on_patch = c_patch && k == 0;
            if (m >= 2 && on_patch) {
                // step m's hard-set, in level m's inputs only
                const int64_t d = (int64_t)(m - 2) * ni + (i - i0);
                eo[0] = 0.f;
                eo[2] = ld(ez_rows, d);
                ho[0] = ld(hx_rows, d);
                ho[2] = 0.f;
            }
            // E of level m-1 on plane k, for the +1 neighbour reads
            sE[0][ty][tx] = eo[0]; sE[1][ty][tx] = eo[1]; sE[2][ty][tx] = eo[2];
            __syncthreads();
            const float ex_pj = ty + 1 < BJ ? sE[0][ty + 1][tx] : 0.f;
            const float ez_pj = ty + 1 < BJ ? sE[2][ty + 1][tx] : 0.f;
            const float ey_pi = tx + 1 < BI ? sE[1][ty][tx + 1] : 0.f;
            const float ez_pi = tx + 1 < BI ? sE[2][ty][tx + 1] : 0.f;

            // H of level m on plane k (Hx, Hy: k < K; Hz: k <= K)
            const bool kh = k >= 0 && k < K;
            const bool khz = k >= 0 && k <= K;
            float hn[3] = {ho[0], ho[1], ho[2]};
            if (kh && c_hx && !on_patch) hn[0] = leap(ho[0], fh, e[m - 1][1], eo[1], ez_pj, eo[2]);
            if (kh && c_hy) hn[1] = leap(ho[1], fh, ez_pi, eo[2], e[m - 1][0], eo[0]);
            if (khz && c_hz && !on_patch) hn[2] = leap(ho[2], fh, ex_pj, eo[0], ey_pi, eo[1]);

            sH[0][ty][tx] = hn[0]; sH[1][ty][tx] = hn[1]; sH[2][ty][tx] = hn[2];
            __syncthreads();
            const float hx_mj = ty > 0 ? sH[0][ty - 1][tx] : 0.f;
            const float hz_mj = ty > 0 ? sH[2][ty - 1][tx] : 0.f;
            const float hy_mi = tx > 0 ? sH[1][ty][tx - 1] : 0.f;
            const float hz_mi = tx > 0 ? sH[2][ty][tx - 1] : 0.f;

            // E of level m on plane k (Ex, Ey: 1 <= k < K; Ez: k < K);
            // h[m] still holds level m's H on plane k-1
            const bool ke = k >= 1 && k < K;
            const bool kez = k >= 0 && k < K;
            float en[3] = {eo[0], eo[1], eo[2]};
            if (ke && c_ex) en[0] = leap(eo[0], fe, hn[2], hz_mj, hn[1], h[m][1]);
            if (ke && c_ey) en[1] = leap(eo[1], fe, hn[0], h[m][0], hn[2], hz_mi);
            if (kez && c_ez) en[2] = leap(eo[2], fe, hn[1], hy_mi, hn[0], hx_mj);

            if (m < S) {
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    eo[c] = e[m][c];
                    ho[c] = h[m][c];
                    e[m][c] = en[c];
                    h[m][c] = hn[c];
                }
            } else {
#pragma unroll
                for (int c = 0; c < 3; ++c) h[m][c] = hn[c];
                if (emit && k >= k0 && k < k1) {
                    const int64_t o = (int64_t)k * sk + col;
                    st(out.ex, o, en[0]); st(out.ey, o, en[1]); st(out.ez, o, en[2]);
                    st(out.hx, o, hn[0]); st(out.hy, o, hn[1]); st(out.hz, o, hn[2]);
                }
            }
        }
    }
}

template <typename T, int S, int BJ>
int launch(void* const* in, void* const* out, int K, int J, int I, float fh, float fe,
           int tk, int has_patch, int j0, int j1, int i0, int i1,
           const void* ez_rows, const void* hx_rows, cudaStream_t stream) {
    constexpr int TJ = BJ - 2 * S;
    constexpr int TI = BI - 2 * S;
    const Fields<T> f_in{(const T*)in[0], (const T*)in[1], (const T*)in[2],
                         (const T*)in[3], (const T*)in[4], (const T*)in[5]};
    const OutFields<T> f_out{(T*)out[0], (T*)out[1], (T*)out[2], (T*)out[3], (T*)out[4], (T*)out[5]};
    const dim3 block(BI, BJ);
    const dim3 grid((unsigned)((I + 1 + TI - 1) / TI), (unsigned)((J + 1 + TJ - 1) / TJ),
                    (unsigned)((K + 1 + tk - 1) / tk));
    stream_kernel<T, S, BJ><<<grid, block, 0, stream>>>(
        f_in, f_out, K, J, I, fh, fe, tk, has_patch, j0, j1, i0, i1,
        (const T*)ez_rows, (const T*)hx_rows);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int s, int bj, void* const* in, void* const* out, int K, int J, int I, float fh,
             float fe, int tk, int has_patch, int j0, int j1, int i0, int i1,
             const void* ez_rows, const void* hx_rows, cudaStream_t stream) {
    // the (s, threads along j) pairs of ops/stream_plan.py::BLOCK_J
    if (s == 8 && bj == 24)
        return launch<T, 8, 24>(in, out, K, J, I, fh, fe, tk, has_patch, j0, j1, i0, i1, ez_rows, hx_rows, stream);
    if (s == 4 && bj == 32)
        return launch<T, 4, 32>(in, out, K, J, I, fh, fe, tk, has_patch, j0, j1, i0, i1, ez_rows, hx_rows, stream);
    if (s == 2 && bj == 32)
        return launch<T, 2, 32>(in, out, K, J, I, fh, fe, tk, has_patch, j0, j1, i0, i1, ez_rows, hx_rows, stream);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// in, out: six pointers each (ex, ey, ez, hx, hy, hz); out must not alias
// in.  ez_rows, hx_rows: (s-1) x (i1-i0) drive rows in the storage dtype
// (unused without the patch).  Launches on `stream` and returns
// cudaGetLastError().
extern "C" {

int yee_stream_sweep(void* const* in, void* const* out, int K, int J, int I, float fh, float fe,
                     int s, int bj, int bi, int tk, int has_patch, int j0, int j1, int i0, int i1,
                     const void* ez_rows, const void* hx_rows, int dtype, void* stream) {
    if (bi != BI || tk < 1 || (has_patch && (ez_rows == nullptr || hx_rows == nullptr)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0)
        return dispatch<float>(s, bj, in, out, K, J, I, fh, fe, tk, has_patch, j0, j1, i0, i1,
                               ez_rows, hx_rows, st);
    if (dtype == 1)
        return dispatch<__nv_bfloat16>(s, bj, in, out, K, J, I, fh, fe, tk, has_patch, j0, j1, i0, i1,
                                       ez_rows, hx_rows, st);
    return (int)cudaErrorInvalidValue;
}

const char* yee_stream_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
