// Per-step DFT accumulation for Hopper (sm_90a): the E phasor sums of one
// step, added in place; and the per-step SAR increment, which reads the
// same E cell means.
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
//
// Shards (fdtd_tpu_torch/parallel; replaces the per-shard sharded cell
// means of fdtd_tpu/parallel/sharded_fast.py's trailing steps): with BOX a
// launch covers a shard's owned cells, reading E from the shard's arrays
// (its halo plane above, copied in before, gives the +1 edges) and adding
// to the shard's (nf, nc, cnk, cnj, cni) part of the sums; every cell gets
// the operations of the whole-grid launch on the same values.  The
// whole-grid instantiation compiles as before (only BOX reads the box).
//
// The SAR increment (sar_accum_kernel) replaces no Pallas kernel: the JAX
// package runs the per-step deposition as XLA glue inside its jitted step
// (fdtd_tpu/step.py:384-397, power_deposition_stripped), which XLA fuses
// into one loop; eager torch ops make it about 20 launches a step, each a
// round trip of the whole grid through device memory.  Its plain version is
// fdtd_tpu_torch/diagnostics.py::accumulate_power.  For each cell of the
// (K, J, I) grid, with mx, my, mz the 4-edge E cell means above (mean4):
//
//     acc[cell] = acc[cell] + (sigma[cell] * ((mx*mx + my*my) + mz*mz)) * dt
//
// sigma stored in the field dtype and widened to fp32, acc the fp32 map, dt
// the step rounded to fp32, each operation rounded on its own, so the map
// equals the torch ops' bits.  Bytes bind it: E read once (3 x 257^3 x 4 B
// = 203.7 MB at 256^3 in fp32), sigma (67.1 MB) and the map read and
// written (134.2 MB): 405 MB a step, 0.121 ms at 3.35 TB/s; its 20
// operations a cell take about 5 us at 67 TFLOP/s.  Design: dft_accum_kernel's,
// one thread per cell, i fastest, the 12 E edges shared by neighbouring
// threads through L1/L2 (the planes k and k+1 of the blocks in flight stay
// in L2), sigma and the map streamed once.  With BOX a launch covers a
// shard's owned cells, read from the shard's arrays, as K4-shard does.
//
// The fold (dft_fold_kernel) replaces no TPU kernel: it is the second half
// of the sweeps' means mode (yee_stream.cu, "DFT"), which the TPU kernels
// do not need, as their VMEM holds the sums of the cells in flight at any
// frequency count that their plans admit.  A means-mode sweep stores each
// level's three E cell means, fp32, into a (D, 3, cells) buffer; the fold
// adds the first `depth` levels to the (re, im) sums of every frequency,
// in step order, with the operations of `depth` calls of dft.accumulate:
//
//     re[f][c][cell] = re[f][c][cell] + cw[d][f] * m[d][c][cell]
//     im[f][c][cell] = im[f][c][cell] - sw[d][f] * m[d][c][cell]
//
// for d = 0 .. depth-1, each product and sum rounded on its own, so the
// sums equal the per-step accumulation's bits.  Its plain version is
// fdtd_tpu_torch/ops/dft.py::plain_fold.  Bytes bind it: per cell it reads
// 12 * depth B of means once and reads and writes 48 * nf B of sums once
// (per step of the buffer: 12 + 48 * nf / depth B, against K4's 48 * nf),
// at 12 * depth * nf operations, four a level and frequency, each its own
// instruction (no fused multiply-add): at 16 frequencies and 32 levels they
// take more than half the bytes' time, so the fold must overlap both.  Design: one thread per
// (component, cell), i fastest, the cell's `depth` means in registers
// (FOLD_MAX levels at most, loaded together, so their latencies overlap),
// then the frequencies four at a time (two where fewer than eight leave a
// last group half empty: dft_fold), a group's sums in registers while the
// next group's (re, im) pairs load, the weights of a level and group read
// as 16-byte vectors from shared memory (staged for up to FOLD_FT
// frequencies), at two 256-thread blocks an SM (four with pairs; 80 and
// 64 registers).  The first design, one frequency ahead and an 8-byte
// weight read a level and frequency, kept about 6 KB in flight an SM while
// the sums streamed: 70% of the bound against 83-93% now (PERF.md).  A
// design that stages a block's tile of the buffer in shared memory and
// moves four cells' sums a thread in 16-byte loads measured up to 6%
// faster at 5-8 frequencies and no faster elsewhere, and takes cells % 4
// == 0 alone; it is not built.  A shard folds its own buffer into its part
// of the sums: only the cell count matters.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

__device__ __forceinline__ float ld(const float* p, int64_t o) { return p[o]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int64_t o) { return __bfloat162float(p[o]); }

__device__ __forceinline__ float mean4(float a, float b, float c, float d) {
    return __fmul_rn(0.25f, __fadd_rn(__fadd_rn(__fadd_rn(a, b), c), d));
}

// A shard's part: its arrays hold (nk, nj, ni) elements from the global
// cell (ok, oj, oi); its cells are (cnk, cnj, cni) from (ck0, cj0, ci0)
struct Box {
    int nj, ni, ok, oj, oi;
    int ck0, cj0, ci0, cnk, cnj, cni;
};

// The E cell means (mx, my, mz) of `cell`, the index of a cell of the
// launch (i fastest; with BOX of the shard's owned cells)
template <typename T, bool BOX>
__device__ __forceinline__ void cell_means(const T* __restrict__ ex, const T* __restrict__ ey,
                                           const T* __restrict__ ez, int K, int J, int I, const Box& g, int64_t cell,
                                           float (&m)[3]) {
    int64_t o, sj, sk;
    if constexpr (BOX) {
        const int i = g.ci0 + (int)(cell % g.cni);
        const int j = g.cj0 + (int)((cell / g.cni) % g.cnj);
        const int k = g.ck0 + (int)(cell / ((int64_t)g.cni * g.cnj));
        sj = g.ni;
        sk = sj * g.nj;
        o = (int64_t)(k - g.ok) * sk + (int64_t)(j - g.oj) * sj + (i - g.oi);
    } else {
        const int i = (int)(cell % I);
        const int j = (int)((cell / I) % J);
        const int k = (int)(cell / ((int64_t)I * J));
        sj = (int64_t)I + 1;
        sk = sj * ((int64_t)J + 1);
        o = (int64_t)k * sk + (int64_t)j * sj + i;
    }
    m[0] = mean4(ld(ex, o), ld(ex, o + sk), ld(ex, o + sj), ld(ex, o + sk + sj));
    m[1] = mean4(ld(ey, o), ld(ey, o + 1), ld(ey, o + sk), ld(ey, o + sk + 1));
    m[2] = mean4(ld(ez, o), ld(ez, o + sj), ld(ez, o + 1), ld(ez, o + sj + 1));
}

template <typename T, bool BOX>
__global__ void __launch_bounds__(256)
dft_accum_kernel(const T* __restrict__ ex, const T* __restrict__ ey, const T* __restrict__ ez, int K, int J,
                 int I, const float* __restrict__ w, int nf, int nc, float* __restrict__ re,
                 float* __restrict__ im, Box g) {
    const int64_t cells = BOX ? (int64_t)g.cnk * g.cnj * g.cni : (int64_t)K * J * I;
    const int64_t cell = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (cell >= cells) return;
    float m[3];
    cell_means<T, BOX>(ex, ey, ez, K, J, I, g, cell, m);
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

// One thread per cell (the SAR design in the header above)
template <typename T, bool BOX>
__global__ void __launch_bounds__(256)
sar_accum_kernel(const T* __restrict__ ex, const T* __restrict__ ey, const T* __restrict__ ez, int K, int J,
                 int I, const T* __restrict__ sigma, float dt, float* __restrict__ acc, Box g) {
    const int64_t cells = BOX ? (int64_t)g.cnk * g.cnj * g.cni : (int64_t)K * J * I;
    const int64_t cell = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (cell >= cells) return;
    float m[3];
    cell_means<T, BOX>(ex, ey, ez, K, J, I, g, cell, m);
    const float esq = __fadd_rn(__fadd_rn(__fmul_rn(m[0], m[0]), __fmul_rn(m[1], m[1])), __fmul_rn(m[2], m[2]));
    const float inc = __fmul_rn(ld(sigma, cell), esq);
    acc[cell] = __fadd_rn(acc[cell], __fmul_rn(inc, dt));
}

constexpr int FOLD_MAX = 32;      // levels a fold takes at most (ops/stream_plan.py::FOLD_DEPTH)
constexpr int FOLD_FT = 32;       // frequencies whose weights a block stages at a time
constexpr int FOLD_THREADS = 256;

// the (cos, sin) weights of frequencies f0 .. f0+nt-1 at levels 0 .. depth-1,
// FP frequencies of one level side by side (one vector read a level):
// ws[((q / FP) * FOLD_MAX + d) * FP + q % FP] for frequency f0 + q
template <int FP>
__device__ __forceinline__ void stage_weights(float2* ws, const float* __restrict__ w, int depth, int nf, int f0,
                                              int nt) {
    for (int t = threadIdx.x; t < nt * depth; t += blockDim.x) {
        const int d = t / nt, q = t % nt;
        ws[((q / FP) * FOLD_MAX + d) * FP + q % FP] =
            make_float2(w[(int64_t)(2 * d) * nf + f0 + q], w[(int64_t)(2 * d + 1) * nf + f0 + q]);
    }
}

// the FP weight pairs of level d of a group
template <int FP>
__device__ __forceinline__ void weights_at(const float2* wg, int d, float2 (&cs)[FP]) {
    if constexpr (FP % 2 == 0) {
        const float4* v = reinterpret_cast<const float4*>(wg + d * FP);
#pragma unroll
        for (int p = 0; p < FP / 2; ++p) {
            const float4 q = v[p];
            cs[2 * p] = make_float2(q.x, q.y);
            cs[2 * p + 1] = make_float2(q.z, q.w);
        }
    } else {
#pragma unroll
        for (int p = 0; p < FP; ++p) cs[p] = wg[d * FP + p];
    }
}

// One thread per (component, cell) x = c * cells + cell, i fastest (the
// design in the header above), FP frequencies a group, NB blocks an SM.
template <int FP, int NB>
__global__ void __launch_bounds__(FOLD_THREADS, NB)
dft_fold_kernel(const float* __restrict__ mb, int depth, int64_t cells, const float* __restrict__ w, int nf, int nc,
                float* __restrict__ re, float* __restrict__ im) {
    __shared__ __align__(16) float2 ws[FOLD_FT * FOLD_MAX];
    const int64_t x = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = x < 3 * cells;
    float m[FOLD_MAX];
#pragma unroll
    for (int d = 0; d < FOLD_MAX; ++d) m[d] = (live && d < depth) ? __ldg(mb + (int64_t)d * 3 * cells + x) : 0.f;
    const int64_t fs = (int64_t)nc * cells;  // the sums' stride from one frequency to the next
    for (int f0 = 0; f0 < nf; f0 += FOLD_FT) {
        const int nt = min(FOLD_FT, nf - f0);
        __syncthreads();
        stage_weights<FP>(ws, w, depth, nf, f0, nt);
        __syncthreads();
        if (!live) continue;
        float* pr = re + f0 * fs + x;
        float* pi = im + f0 * fs + x;
        float cr[FP], ci[FP];
#pragma unroll
        for (int p = 0; p < FP; ++p) {
            cr[p] = p < nt ? pr[p * fs] : 0.f;
            ci[p] = p < nt ? pi[p * fs] : 0.f;
        }
        for (int g = 0; g < nt; g += FP) {
            float nr[FP], ni[FP];
#pragma unroll
            for (int p = 0; p < FP; ++p) {
                const bool ahead = g + FP + p < nt;
                nr[p] = ahead ? pr[(FP + p) * fs] : 0.f;
                ni[p] = ahead ? pi[(FP + p) * fs] : 0.f;
            }
            const float2* wg = ws + (g / FP) * FOLD_MAX * FP;
#pragma unroll
            for (int d = 0; d < FOLD_MAX; ++d) {
                if (d < depth) {
                    float2 cs[FP];
                    weights_at<FP>(wg, d, cs);
#pragma unroll
                    for (int p = 0; p < FP; ++p) {
                        cr[p] = __fadd_rn(cr[p], __fmul_rn(cs[p].x, m[d]));
                        ci[p] = __fsub_rn(ci[p], __fmul_rn(cs[p].y, m[d]));
                    }
                }
            }
#pragma unroll
            for (int p = 0; p < FP; ++p) {
                if (g + p < nt) {
                    pr[p * fs] = cr[p];
                    pi[p * fs] = ci[p];
                }
                cr[p] = nr[p];
                ci[p] = ni[p];
            }
            pr += FP * fs;
            pi += FP * fs;
        }
    }
}

// The Box of a per-step launch and its cell count: the whole grid (geom
// null), or a shard's 12 ints (the interface below); false on a box that
// does not hold its window and the plane above it
bool launch_box(int K, int J, int I, const int* geom, Box& g, int64_t& cells) {
    if (K < 1 || J < 1 || I < 1) return false;
    cells = (int64_t)K * J * I;
    if (geom == nullptr) return true;
    const int n[3] = {K + 1, J + 1, I + 1};
    for (int a = 0; a < 3; ++a) {
        const int ext = geom[a], org = geom[3 + a], lo = geom[6 + 2 * a], hi = geom[7 + 2 * a];
        if (ext < 1 || lo < 0 || hi > n[a] || lo >= hi || org > lo || org + ext < std::min(hi + 1, n[a]))
            return false;
    }
    g = Box{geom[1], geom[2], geom[3], geom[4], geom[5], geom[6], geom[8], geom[10],
            std::min(geom[7], K) - geom[6], std::min(geom[9], J) - geom[8], std::min(geom[11], I) - geom[10]};
    if (g.cnk < 1 || g.cnj < 1 || g.cni < 1) return false;
    cells = (int64_t)g.cnk * g.cnj * g.cni;
    return true;
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// e: three pointers (ex, ey, ez), each (K+1, J+1, I+1) in the storage dtype;
// w: 2*nf fp32 (cos, then sin); re, im: (nf, nc, K, J, I) fp32, updated in
// place.  geom: null for the whole grid, or a shard's 12 ints: its arrays'
// extents (nk, nj, ni), the global index of their origin (ok, oj, oi) and
// its owned window (wk0, wk1, wj0, wj1, wi0, wi1), global; e are then the
// shard's arrays, which must hold the window and one plane above it where
// the grid goes on, and re, im its (nf, nc, cnk, cnj, cni) part, the cells
// of the window.  Launches on `stream` and returns cudaGetLastError().
extern "C" {

int dft_accum(void* const* e, int K, int J, int I, const int* geom, const void* w, int nf, int nc, void* re,
              void* im, int dtype, void* stream) {
    if (w == nullptr || re == nullptr || im == nullptr || nf < 1 || nc < 3) return (int)cudaErrorInvalidValue;
    Box g{};
    int64_t cells = 0;
    if (!launch_box(K, J, I, geom, g, cells)) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((cells + 255) / 256);
    cudaStream_t st = (cudaStream_t)stream;
#define DFT_ACCUM_LAUNCH(T_, BOX_)                                                                              \
    dft_accum_kernel<T_, BOX_><<<blocks, 256, 0, st>>>((const T_*)e[0], (const T_*)e[1], (const T_*)e[2], K, J, I, \
                                                       (const float*)w, nf, nc, (float*)re, (float*)im, g)
    if (dtype == 0) {
        if (geom != nullptr) DFT_ACCUM_LAUNCH(float, true);
        else DFT_ACCUM_LAUNCH(float, false);
    } else if (dtype == 1) {
        if (geom != nullptr) DFT_ACCUM_LAUNCH(__nv_bfloat16, true);
        else DFT_ACCUM_LAUNCH(__nv_bfloat16, false);
    } else {
        return (int)cudaErrorInvalidValue;
    }
#undef DFT_ACCUM_LAUNCH
    return (int)cudaGetLastError();
}

// sar_accum: e as for dft_accum (with geom, a shard's arrays); sigma the
// (K, J, I) cell conductivity in the storage dtype and acc the (K, J, I)
// fp32 map, updated in place (with geom: the shard's (cnk, cnj, cni) parts,
// the cells of its window); dt the step rounded to fp32.  Launches on
// `stream` and returns cudaGetLastError().
int sar_accum(void* const* e, int K, int J, int I, const int* geom, const void* sigma, float dt, void* acc,
              int dtype, void* stream) {
    if (sigma == nullptr || acc == nullptr) return (int)cudaErrorInvalidValue;
    Box g{};
    int64_t cells = 0;
    if (!launch_box(K, J, I, geom, g, cells)) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((cells + 255) / 256);
    cudaStream_t st = (cudaStream_t)stream;
#define SAR_ACCUM_LAUNCH(T_, BOX_)                                                                              \
    sar_accum_kernel<T_, BOX_><<<blocks, 256, 0, st>>>((const T_*)e[0], (const T_*)e[1], (const T_*)e[2], K, J, I, \
                                                       (const T_*)sigma, dt, (float*)acc, g)
    if (dtype == 0) {
        if (geom != nullptr) SAR_ACCUM_LAUNCH(float, true);
        else SAR_ACCUM_LAUNCH(float, false);
    } else if (dtype == 1) {
        if (geom != nullptr) SAR_ACCUM_LAUNCH(__nv_bfloat16, true);
        else SAR_ACCUM_LAUNCH(__nv_bfloat16, false);
    } else {
        return (int)cudaErrorInvalidValue;
    }
#undef SAR_ACCUM_LAUNCH
    return (int)cudaGetLastError();
}

// dft_fold: means the (>= depth, 3, cells) fp32 buffer of a means-mode
// sweep, of which the first `depth` (1 to FOLD_MAX) levels are added; w the
// buffered steps' (depth, 2, nf) fp32 (cos, sin) rows; re, im: (nf, nc,
// cells) fp32, the E components updated in place.  Launches on `stream` and
// returns cudaGetLastError().
int dft_fold(const void* means, int depth, int64_t cells, const void* w, int nf, int nc, void* re, void* im,
             void* stream) {
    if (means == nullptr || w == nullptr || re == nullptr || im == nullptr || depth < 1 || depth > FOLD_MAX
        || cells < 1 || nf < 1 || nc < 3)
        return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((3 * cells + FOLD_THREADS - 1) / FOLD_THREADS);
    // groups of four frequencies at two blocks an SM, but groups of two at
    // four where a last group of four would be half empty or worse (nf % 4
    // of 1 or 2) and nf < 8: at 256^3 x 32 levels, 3.586 against 3.842 ms at
    // nf = 5, 2.401 against 2.595 at nf = 1; a tie at nf = 6 (NVIDIA H100
    // 80GB HBM3, 700 W; PERF.md)
    const bool pairs = nf < 8 && (nf % 4 == 1 || nf % 4 == 2);
    auto kernel = pairs ? dft_fold_kernel<2, 4> : dft_fold_kernel<4, 2>;
    kernel<<<blocks, FOLD_THREADS, 0, (cudaStream_t)stream>>>((const float*)means, depth, cells, (const float*)w, nf,
                                                              nc, (float*)re, (float*)im);
    return (int)cudaGetLastError();
}

const char* dft_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
