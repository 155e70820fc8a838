// Two-pass Yee leapfrog update for Hopper (sm_90a): the H half-step and the
// E half-step of a closed PEC cavity, each one kernel launch that updates
// all three components in place.  Vacuum takes scalar factors; the material
// variants take per-cell factors: the H pass three hf arrays (heterogeneous
// mu_r), the E pass six ca/cb arrays (lossy media, E = ca*E + cb*curl H).
// The CPML variants (PML, composing with both) advance the six memory
// variables of their pass beside the fields.  The ADE E pass (Debye media,
// ade_e_kernel) advances the polarization P beside E.
//
// Replaces the TPU kernels fdtd_tpu/ops/pallas_fused.py::_h_kernel2 (H pass,
// vacuum and `het`) and ::_e_kernel2 (E pass, vacuum and `lossy`), and with
// PML fdtd_tpu/ops/cpml_kernel.py::_h_kernel_pml / ::_e_kernel_pml, whose
// four k-axis terms ran as XLA slab updates after the kernels: here all six
// terms of a pass run in the kernel.  It works on the canonical uniform padded
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
// Shards (fdtd_tpu_torch/parallel): a launch may update a part of the grid
// held in arrays of its own (a shard's box, halos included; see Box below):
// the arrays' extents set the strides, and every bound, PEC wall and the
// source patch test global indices, so a shard's owned cells get the
// operations of the whole-grid launch on the same values.  This replaces
// the leading (global-k, global-j) offset operand and `jwin` of the TPU's
// per-shard calls (fdtd_tpu/ops/pallas_fused.py::build_twopass_calls).  The
// whole grid is the box with no offset that owns everything.
//
// Numerics: fp32 storage computes in fp32; bf16 storage loads to fp32,
// computes in fp32 and rounds back with __float2bfloat16_rn.  Every operation
// is an explicitly rounded __fsub_rn/__fmul_rn/__fadd_rn in the order of
// ops/curl.py (lossy: ca*E + cb*curl, two products then the sum), and
// coefficients stored in bf16 widen to fp32 exactly, and the library is built with -fmad=false, so the result is
// bit-equal to the plain version on the same card.  Offsets are 64-bit:
// a 1025^3 array has more than 2^31 elements.
//
// ADE (plain version: fdtd_tpu_torch/ops/dispersive.py::update_e_ade).
// Replaces fdtd_tpu/ops/pallas_dispersive.py::_e_kernel_ade (the TPU's
// two-pass ADE E pass; its H pass is the vacuum K1, here h_kernel<T, false,
// false>).  Per updated edge, from the 15 per-edge maps (ca, cb, cp, k1, k2):
// E' = ((ca*E + cb*curl) + cp*P), P' = k1*P + k2*(E' + E), E' and P' kept in
// fp32 until the store.  With SAR it also writes the fp32 edge work
// w = E_mid*((P' - P)/dt + sig*E_mid), E_mid = 0.5*(E' + E), with a true
// division by the fp32 dt, and 0 on every edge it does not update, so the
// three work arrays need no clearing.  The maps are per edge everywhere
// (edge averaging gives the load's boundary edges values of their own).
// Cost: it reads H, E, P and the 15 maps and writes E and P: 120 B per cell
// in fp32 (60 B in bf16); SAR adds the three sigma maps and the three work
// arrays, 144 B (78 B).  It is bound by bytes, like the lossy E pass.
//
// CPML (plain versions: fdtd_tpu_torch/ops/cpml.py::Cpml.plain_h/plain_e).
// psi is the slab-restricted layout of ops/cpml.py::psi_shapes: each term's
// array covers its target's update region with 2n rows along its PML axis
// (the lo slab, then the hi slab), so the thread that updates a field cell
// owns that cell's psi of every term whose slab holds it, and updates it in
// place (psi is pointwise and a pass reads only the other field).  Per
// target, in the order of ops/cpml.py::_TERMS: the curl update, then the
// j/i term(s), then the k term, each psi = b*psi + c*d and each add
// field +- factor*psi rounded on its own; d is the curl's own difference,
// the factor the curl's (f or hf in H, f or cb in E).  In the H pass, Hx
// and Hz on the k=0 source patch keep their values: the curl update and
// the four adds are skipped there, the recursions still run.  The psi
// traffic is the slab volume: about 12 * 2n / N of the field state per
// step, read and written once.  A shard's CPML launch (replacing the TPU's
// per-shard K1/K2 plus XLA slab corrections,
// fdtd_tpu/parallel/sharded_pml_fast.py::make_sharded_pml_fast_step) holds
// its part of each psi array: the slab rows whose cells lie in its owned
// window (ops/cpml.py::psi_part_slices; a k slab may straddle two shards,
// and a shard may hold none of a slab), addressed through the part's origin
// and extents (PsiPart); the canonical slab row still picks the (b, c) of
// the table.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

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

// CPML memory variables of one pass: the six psi arrays in _TERMS order
// (H: hx_y, hx_z, hy_x, hy_z, hz_y, hz_x; E: ex_y, ex_z, ey_x, ey_z, ez_x,
// ez_y) and their recursion table, b of term t at row q: tab[2t*2n + q],
// c: tab[(2t+1)*2n + q] (field dtype)
template <typename T>
struct Psi {
    T* p[6];
    const T* tab;
    int n;  // slab depth in cells
};

// the row of region coordinate x (region length len) in the 2n-row slab
// layout, or -1 between the slabs
__device__ __forceinline__ int slab_row(int x, int len, int n) {
    return x < n ? x : (x >= len - n ? x - (len - 2 * n) : -1);
}

// the offset of local cell (lk, lj, li) of a (Lk, Lj, Li) region in the psi
// array of a term along `axis`, or -1 outside its slabs; *row: its slab row
__device__ __forceinline__ int64_t psi_index(int axis, int lk, int lj, int li, int Lk, int Lj, int Li,
                                             int n, int* row) {
    const int w = 2 * n;
    if (axis == 0) {
        *row = slab_row(lk, Lk, n);
        return *row < 0 ? -1 : ((int64_t)*row * Lj + lj) * Li + li;
    }
    if (axis == 1) {
        *row = slab_row(lj, Lj, n);
        return *row < 0 ? -1 : ((int64_t)lk * w + *row) * Li + li;
    }
    *row = slab_row(li, Li, n);
    return *row < 0 ? -1 : ((int64_t)lk * Lj + lj) * w + *row;
}

constexpr int BX = 64;  // threads along i
constexpr int BY = 4;   // threads along j

// A shard's part of the psi arrays of a pass (fdtd_tpu_torch/ops/cpml.py::
// psi_part_slices: the rows of each term's slab-restricted array whose cells
// lie in the shard's owned window): per term t, its extents e1, e2 along
// axes 1 and 2 and its origin in the canonical array, folded into
// base[t] = (o0 * e1 + o1) * e2 + o2.
struct PsiPart {
    int64_t base[6];
    int e1[6], e2[6];
};

// The part of the grid a launch updates: the arrays hold (nk, nj, ni)
// elements whose local (0, 0, 0) is the global cell (ok, oj, oi), and the
// launch updates the global window [wk0, wk0 + gridDim.z) x [wj0, wj1) x
// [wi0, wi1) (a shard's owned planes; the whole grid: every cell, from 0);
// a CPML shard launch indexes its psi parts through pp.
struct Box {
    int nj, ni;      // local extents along j and i (the strides)
    int ok, oj, oi;  // global index of the local origin
    int wk0, wj0, wi0, wj1, wi1;
    PsiPart pp;
};

// the offset of cell (lk, lj, li) of a term's (Lk, Lj, Li) region (global
// coordinates less the region's origin) in a shard's part of the term's
// psi array, or -1 outside its slabs; *row: its canonical slab row
__device__ __forceinline__ int64_t psi_part_index(const PsiPart& pp, int t, int axis, int lk, int lj, int li,
                                                  int Lk, int Lj, int Li, int n, int* row) {
    int c[3] = {lk, lj, li};
    const int len[3] = {Lk, Lj, Li};
    *row = slab_row(c[axis], len[axis], n);
    if (*row < 0) return -1;
    c[axis] = *row;
    return ((int64_t)c[0] * pp.e1[t] + c[1]) * pp.e2[t] + c[2] - pp.base[t];
}

// psi of term t at q (slab row `row`) <- b*psi + c*d, stored; returns the
// new psi in fp32 (the value the field adds)
template <typename T>
__device__ __forceinline__ float psi_step(const Psi<T>& ps, int t, int64_t q, int row, float d) {
    const int64_t w = 2 * ps.n;
    const float b = ld(ps.tab, 2 * t * w + row);
    const float c = ld(ps.tab, (2 * t + 1) * w + row);
    const float v = __fadd_rn(__fmul_rn(b, ld(ps.p[t], q)), __fmul_rn(c, d));
    st(ps.p[t], q, v);
    return v;
}

// field v <- v + sign * f * (the new psi of term t), where the cell lies in
// that term's slab along `axis` (BOX: in a shard's psi part, g.pp)
template <bool BOX, typename T>
__device__ __forceinline__ float psi_add(const Psi<T>& ps, const Box& g, int t, int axis, int sign, float v,
                                         float f, float d, int lk, int lj, int li, int Lk, int Lj, int Li) {
    int row;
    int64_t q;
    if constexpr (BOX)
        q = psi_part_index(g.pp, t, axis, lk, lj, li, Lk, Lj, Li, ps.n, &row);
    else
        q = psi_index(axis, lk, lj, li, Lk, Lj, Li, ps.n, &row);
    if (q < 0) return v;
    const float corr = __fmul_rn(f, psi_step(ps, t, q, row, d));
    return sign > 0 ? __fadd_rn(v, corr) : __fsub_rn(v, corr);
}

// the global cell of this thread and its local offset; false outside the
// window.  BOX: a shard's launch, its geometry the runtime box g; without it
// the whole grid's, compiled as it was before shards existed (a runtime box
// in every variant cost the CPML H pass 9-14% at 256^3), so only the shard
// variants carry it.  z: the block's k index in the window (blockIdx.z, or
// its k part in a batched launch).
template <bool BOX>
__device__ __forceinline__ bool locate(const Box& g, int J, int I, unsigned z, int& k, int& j, int& i, int64_t& c,
                                       int64_t& sj, int64_t& sk) {
    if constexpr (BOX) {
        i = g.wi0 + (int)(blockIdx.x * BX + threadIdx.x);
        j = g.wj0 + (int)(blockIdx.y * BY + threadIdx.y);
        k = g.wk0 + (int)z;
        sj = g.ni;
        sk = sj * g.nj;
        c = (int64_t)(k - g.ok) * sk + (int64_t)(j - g.oj) * sj + (i - g.oi);
        return i < g.wi1 && j < g.wj1;
    } else {
        i = blockIdx.x * BX + threadIdx.x;
        j = blockIdx.y * BY + threadIdx.y;
        k = z;
        if (i > I || j > J) return false;
        sj = (int64_t)I + 1;
        sk = sj * ((int64_t)J + 1);
        c = (int64_t)k * sk + (int64_t)j * sj + i;
        return true;
    }
}

// A batched launch (BATCH: the members of a sweep, fdtd_tpu_torch/sweep.py)
// runs one kernel over N members whose arrays are the contiguous views [b]
// of (N, K+1, J+1, I+1) tensors: blockIdx.z = b * (K + 1) + k, and member
// b's six fields start b * (K+1)(J+1)(I+1) elements after member 0's.  It
// replaces N launches of the same pass (the JAX package's vmapped
// _h_kernel2/_e_kernel2 run the batch as one program); each member gets the
// whole-grid launch's operations on its own arrays.  Sets z to the block's
// k index and returns the member's element offset.
__device__ __forceinline__ int64_t batch_offset(int K, int J, int I, unsigned& z) {
    const unsigned m = blockIdx.z / (unsigned)(K + 1);
    z = blockIdx.z - m * (unsigned)(K + 1);
    return (int64_t)m * ((int64_t)K + 1) * ((int64_t)J + 1) * ((int64_t)I + 1);
}

// H half-step over Hx k<K, j<J, i<=I; Hy k<K, j<=J, i<I; Hz k<=K, j<J, i<I.
// With has_patch, Hx and Hz at k=0, j0<=j<j1, i0<=i<i1 keep their values
// (the source hard-set there wins, reference main.c:770-778).  HET reads
// the factor of each component from hf.a[0..2] at the cell instead of f.
// PML advances the six H psi terms of the cell (ps) and adds them.  BATCH
// (vacuum only): a batched launch over the members of a sweep.
template <typename T, bool HET, bool PML, bool BOX, bool BATCH = false>
__global__ void __launch_bounds__(BX * BY)
h_kernel(const T* __restrict__ ex, const T* __restrict__ ey, const T* __restrict__ ez,
         T* __restrict__ hx, T* __restrict__ hy, T* __restrict__ hz,
         int K, int J, int I, float f,
         int has_patch, int j0, int j1, int i0, int i1, Coefs<T> hf, Psi<T> ps, Box g) {
    static_assert(!BATCH || (!HET && !PML && !BOX), "a batched launch is a vacuum whole-grid pass");
    int k, j, i;
    int64_t c, sj, sk;
    unsigned z = blockIdx.z;
    if constexpr (BATCH) {
        const int64_t off = batch_offset(K, J, I, z);
        ex += off;
        ey += off;
        ez += off;
        hx += off;
        hy += off;
        hz += off;
    }
    if (!locate<BOX>(g, J, I, z, k, j, i, c, sj, sk)) return;
    const bool in_patch = has_patch && k == 0 && j >= j0 && j < j1 && i >= i0 && i < i1;

    if (!PML) {
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
        return;
    }
    // PML: the curl's differences feed the psi recursions; regions are the
    // update bounds, local coordinates (k, j, i)
    if (k < K && j < J) {  // Hx: (K, J, I+1); hx_y (-, j, dEz), hx_z (+, k, dEy)
        const float fx = HET ? ld(hf.a[0], c) : f;
        const float dk = __fsub_rn(ld(ey, c + sk), ld(ey, c));
        const float dj = __fsub_rn(ld(ez, c + sj), ld(ez, c));
        const float v0 = __fadd_rn(ld(hx, c), __fmul_rn(fx, __fsub_rn(dk, dj)));
        float v = psi_add<BOX>(ps, g, 0, 1, -1, v0, fx, dj, k, j, i, K, J, I + 1);
        v = psi_add<BOX>(ps, g, 1, 0, +1, v, fx, dk, k, j, i, K, J, I + 1);
        if (!in_patch) st(hx, c, v);
    }
    if (k < K && i < I) {  // Hy: (K, J+1, I); hy_x (+, i, dEz), hy_z (-, k, dEx)
        const float fy = HET ? ld(hf.a[1], c) : f;
        const float di = __fsub_rn(ld(ez, c + 1), ld(ez, c));
        const float dk = __fsub_rn(ld(ex, c + sk), ld(ex, c));
        const float v0 = __fadd_rn(ld(hy, c), __fmul_rn(fy, __fsub_rn(di, dk)));
        float v = psi_add<BOX>(ps, g, 2, 2, +1, v0, fy, di, k, j, i, K, J + 1, I);
        v = psi_add<BOX>(ps, g, 3, 0, -1, v, fy, dk, k, j, i, K, J + 1, I);
        st(hy, c, v);
    }
    if (j < J && i < I) {  // Hz: (K+1, J, I); hz_y (+, j, dEx), hz_x (-, i, dEy)
        const float fz = HET ? ld(hf.a[2], c) : f;
        const float dj = __fsub_rn(ld(ex, c + sj), ld(ex, c));
        const float di = __fsub_rn(ld(ey, c + 1), ld(ey, c));
        const float v0 = __fadd_rn(ld(hz, c), __fmul_rn(fz, __fsub_rn(dj, di)));
        float v = psi_add<BOX>(ps, g, 4, 1, +1, v0, fz, dj, k, j, i, K + 1, J, I);
        v = psi_add<BOX>(ps, g, 5, 2, -1, v, fz, di, k, j, i, K + 1, J, I);
        if (!in_patch) st(hz, c, v);
    }
}

// E half-step over the interior: Ex 1<=k<K, 1<=j<J, i<I; Ey 1<=k<K, j<J,
// 1<=i<I; Ez k<K, 1<=j<J, 1<=i<I.  Tangential E on the walls stays (PEC).
// LOSSY computes ca*E + cb*curl with ca = cf.a[c], cb = cf.b[c] at the cell.
// PML advances the six E psi terms of the cell and adds cb*psi (f*psi).
// BATCH (vacuum only): a batched launch over the members of a sweep.
template <typename T, bool LOSSY, bool PML, bool BOX, bool BATCH = false>
__global__ void __launch_bounds__(BX * BY)
e_kernel(const T* __restrict__ hx, const T* __restrict__ hy, const T* __restrict__ hz,
         T* __restrict__ ex, T* __restrict__ ey, T* __restrict__ ez,
         int K, int J, int I, float f, Coefs<T> cf, Psi<T> ps, Box g) {
    static_assert(!BATCH || (!LOSSY && !PML && !BOX), "a batched launch is a vacuum whole-grid pass");
    int k, j, i;
    int64_t c, sj, sk;
    unsigned z = blockIdx.z;
    if constexpr (BATCH) {
        const int64_t off = batch_offset(K, J, I, z);
        hx += off;
        hy += off;
        hz += off;
        ex += off;
        ey += off;
        ez += off;
    }
    if (!locate<BOX>(g, J, I, z, k, j, i, c, sj, sk)) return;

    if (k >= 1 && k < K && j >= 1 && j < J && i < I) {
        const float a1 = ld(hz, c), a0 = ld(hz, c - sj), b1 = ld(hy, c), b0 = ld(hy, c - sk);
        float v = LOSSY ? lossy(ld(ex, c), ld(cf.a[0], c), ld(cf.b[0], c), a1, a0, b1, b0)
                        : leap(ld(ex, c), f, a1, a0, b1, b0);
        if (PML) {  // Ex: (K-1, J-1, I) from (1, 1, 0); ex_y (+, j, dHz), ex_z (-, k, dHy)
            const float fe = LOSSY ? ld(cf.b[0], c) : f;
            v = psi_add<BOX>(ps, g, 0, 1, +1, v, fe, __fsub_rn(a1, a0), k - 1, j - 1, i, K - 1, J - 1, I);
            v = psi_add<BOX>(ps, g, 1, 0, -1, v, fe, __fsub_rn(b1, b0), k - 1, j - 1, i, K - 1, J - 1, I);
        }
        st(ex, c, v);
    }
    if (k >= 1 && k < K && j < J && i >= 1 && i < I) {
        const float a1 = ld(hx, c), a0 = ld(hx, c - sk), b1 = ld(hz, c), b0 = ld(hz, c - 1);
        float v = LOSSY ? lossy(ld(ey, c), ld(cf.a[1], c), ld(cf.b[1], c), a1, a0, b1, b0)
                        : leap(ld(ey, c), f, a1, a0, b1, b0);
        if (PML) {  // Ey: (K-1, J, I-1) from (1, 0, 1); ey_x (-, i, dHz), ey_z (+, k, dHx)
            const float fe = LOSSY ? ld(cf.b[1], c) : f;
            v = psi_add<BOX>(ps, g, 2, 2, -1, v, fe, __fsub_rn(b1, b0), k - 1, j, i - 1, K - 1, J, I - 1);
            v = psi_add<BOX>(ps, g, 3, 0, +1, v, fe, __fsub_rn(a1, a0), k - 1, j, i - 1, K - 1, J, I - 1);
        }
        st(ey, c, v);
    }
    if (k < K && j >= 1 && j < J && i >= 1 && i < I) {
        const float a1 = ld(hy, c), a0 = ld(hy, c - 1), b1 = ld(hx, c), b0 = ld(hx, c - sj);
        float v = LOSSY ? lossy(ld(ez, c), ld(cf.a[2], c), ld(cf.b[2], c), a1, a0, b1, b0)
                        : leap(ld(ez, c), f, a1, a0, b1, b0);
        if (PML) {  // Ez: (K, J-1, I-1) from (0, 1, 1); ez_x (+, i, dHy), ez_y (-, j, dHx)
            const float fe = LOSSY ? ld(cf.b[2], c) : f;
            v = psi_add<BOX>(ps, g, 4, 2, +1, v, fe, __fsub_rn(a1, a0), k, j - 1, i - 1, K, J - 1, I - 1);
            v = psi_add<BOX>(ps, g, 5, 1, -1, v, fe, __fsub_rn(b1, b0), k, j - 1, i - 1, K, J - 1, I - 1);
        }
        st(ez, c, v);
    }
}

// d / dt, correctly rounded: an IEEE division, except that a zero d (every
// edge where P does not change, most of a scene) returns itself, which is
// what the division gives for a positive dt, without the division's slow
// special-case path
__device__ __forceinline__ float div_dt(float d, float dt) { return d == 0.f ? d : __fdiv_rn(d, dt); }

// The ADE E pass's arrays: the 15 maps in ops/dispersive.py::DebyeCoefs.
// arrays order (ca, cb, cp, k1, k2, each x, y, z; the fields' shape and
// dtype), with SAR the three edge sigma maps (c[15..17]) and the three fp32
// work outputs; dt is the step rounded to fp32.
template <typename T>
struct Ade {
    const T* c[18];
    float* w[3];
    float dt;
};

// one component's ADE update at offset o (component q: 0 x, 1 y, 2 z):
// E and P in place and, with SAR, the edge work
template <typename T, bool SAR>
__device__ __forceinline__ void ade_edge(T* e, T* pol, const Ade<T>& a, int q, int64_t o, float cv) {
    const float eo = ld(e, o), po = ld(pol, o);
    const float en = __fadd_rn(__fadd_rn(__fmul_rn(ld(a.c[q], o), eo), __fmul_rn(ld(a.c[3 + q], o), cv)),
                               __fmul_rn(ld(a.c[6 + q], o), po));
    const float pn = __fadd_rn(__fmul_rn(ld(a.c[9 + q], o), po), __fmul_rn(ld(a.c[12 + q], o), __fadd_rn(en, eo)));
    if (SAR) {
        const float em = __fmul_rn(0.5f, __fadd_rn(en, eo));
        a.w[q][o] = __fmul_rn(em, __fadd_rn(div_dt(__fsub_rn(pn, po), a.dt), __fmul_rn(ld(a.c[15 + q], o), em)));
    }
    st(e, o, en);
    st(pol, o, pn);
}

// The ADE E half-step over the interior bounds of e_kernel: E and P in
// place; with SAR the work of every cell of the padded box (0 off the
// update bounds).
template <typename T, bool SAR>
__global__ void __launch_bounds__(BX * BY)
ade_e_kernel(const T* __restrict__ hx, const T* __restrict__ hy, const T* __restrict__ hz,
             T* __restrict__ ex, T* __restrict__ ey, T* __restrict__ ez,
             T* __restrict__ px, T* __restrict__ py, T* __restrict__ pz, int K, int J, int I, Ade<T> a) {
    int k, j, i;
    int64_t c, sj, sk;
    if (!locate<false>(Box{}, J, I, blockIdx.z, k, j, i, c, sj, sk)) return;

    if (k >= 1 && k < K && j >= 1 && j < J && i < I)
        ade_edge<T, SAR>(ex, px, a, 0, c, curl(ld(hz, c), ld(hz, c - sj), ld(hy, c), ld(hy, c - sk)));
    else if (SAR)
        a.w[0][c] = 0.f;
    if (k >= 1 && k < K && j < J && i >= 1 && i < I)
        ade_edge<T, SAR>(ey, py, a, 1, c, curl(ld(hx, c), ld(hx, c - sk), ld(hz, c), ld(hz, c - 1)));
    else if (SAR)
        a.w[1][c] = 0.f;
    if (k < K && j >= 1 && j < J && i >= 1 && i < I)
        ade_edge<T, SAR>(ez, pz, a, 2, c, curl(ld(hy, c), ld(hy, c - 1), ld(hx, c), ld(hx, c - sj)));
    else if (SAR)
        a.w[2][c] = 0.f;
}

// geom: null (the whole grid) or 12 ints: the arrays' extents (nk, nj, ni),
// the global index of their origin (ok, oj, oi) and the window to update
// (wk0, wk1, wj0, wj1, wi0, wi1), global; a CPML launch's geom has 30 more:
// per term of its pass, the origin (o0, o1, o2) of the shard's psi part in
// the canonical array and its extents (e1, e2) along axes 1 and 2
struct Launch {
    Box box;
    dim3 grid;
};

Launch launch_of(const int* geom, int K, int J, int I, bool pml = false) {
    Launch l{};
    if (geom == nullptr) {
        l.box = Box{J + 1, I + 1, 0, 0, 0, 0, 0, 0, J + 1, I + 1};
        l.grid = dim3((unsigned)((I + 1 + BX - 1) / BX), (unsigned)((J + 1 + BY - 1) / BY), (unsigned)(K + 1));
        return l;
    }
    l.box = Box{geom[1], geom[2], geom[3], geom[4], geom[5], geom[6], geom[8], geom[10], geom[9], geom[11]};
    if (pml)
        for (int t = 0; t < 6; ++t) {
            const int* q = geom + 12 + 5 * t;
            l.box.pp.e1[t] = q[3];
            l.box.pp.e2[t] = q[4];
            l.box.pp.base[t] = ((int64_t)q[0] * q[3] + q[1]) * q[4] + q[2];
        }
    l.grid = dim3((unsigned)((geom[11] - geom[10] + BX - 1) / BX), (unsigned)((geom[9] - geom[8] + BY - 1) / BY),
                  (unsigned)(geom[7] - geom[6]));
    return l;
}

// a window inside the arrays and the grid, with a neighbour plane on each
// side that is not a wall of the grid (the halos the passes read); a CPML
// launch's psi parts with non-negative origins and extents
bool valid_geom(const int* geom, int K, int J, int I, bool pml = false) {
    if (geom == nullptr) return true;
    const int n[3] = {K + 1, J + 1, I + 1};
    for (int a = 0; a < 3; ++a) {
        const int ext = geom[a], org = geom[3 + a], lo = geom[6 + 2 * a], hi = geom[7 + 2 * a];
        if (ext < 1 || lo < 0 || hi > n[a] || lo >= hi) return false;
        if (org > std::max(lo - 1, 0) || org + ext < std::min(hi + 1, n[a])) return false;
    }
    if (pml)
        for (int q = 12; q < 42; ++q)
            if (geom[q] < 0) return false;
    return true;
}

template <typename T>
Psi<T> psi_args(void* const* psi, const void* tab, int n) {
    Psi<T> ps{};
    if (psi != nullptr)
        for (int q = 0; q < 6; ++q) ps.p[q] = (T*)psi[q];
    ps.tab = (const T*)tab;
    ps.n = n;
    return ps;
}

template <typename T, bool HET, bool PML>
int launch_h(void* const* e, void* const* h, int K, int J, int I, const int* geom, float f, int has_patch,
             int j0, int j1, int i0, int i1, void* const* hf, void* const* psi, const void* tab, int n,
             cudaStream_t s) {
    if (!valid_geom(geom, K, J, I, PML)) return (int)cudaErrorInvalidValue;
    Coefs<T> c{};
    if (HET)
        for (int q = 0; q < 3; ++q) c.a[q] = (const T*)hf[q];
    const Launch l = launch_of(geom, K, J, I, PML);
    const Psi<T> ps = psi_args<T>(psi, tab, n);
    if (geom != nullptr) {
        h_kernel<T, HET, PML, true><<<l.grid, dim3(BX, BY), 0, s>>>(
            (const T*)e[0], (const T*)e[1], (const T*)e[2], (T*)h[0], (T*)h[1], (T*)h[2],
            K, J, I, f, has_patch, j0, j1, i0, i1, c, ps, l.box);
        return (int)cudaGetLastError();
    }
    h_kernel<T, HET, PML, false><<<l.grid, dim3(BX, BY), 0, s>>>(
        (const T*)e[0], (const T*)e[1], (const T*)e[2], (T*)h[0], (T*)h[1], (T*)h[2],
        K, J, I, f, has_patch, j0, j1, i0, i1, c, ps, l.box);
    return (int)cudaGetLastError();
}

template <typename T, bool LOSSY, bool PML>
int launch_e(void* const* h, void* const* e, int K, int J, int I, const int* geom, float f,
             void* const* cf, void* const* psi, const void* tab, int n, cudaStream_t s) {
    if (!valid_geom(geom, K, J, I, PML)) return (int)cudaErrorInvalidValue;
    Coefs<T> c{};
    if (LOSSY)
        for (int q = 0; q < 3; ++q) {
            c.a[q] = (const T*)cf[q];
            c.b[q] = (const T*)cf[3 + q];
        }
    const Launch l = launch_of(geom, K, J, I, PML);
    const Psi<T> ps = psi_args<T>(psi, tab, n);
    if (geom != nullptr) {
        e_kernel<T, LOSSY, PML, true><<<l.grid, dim3(BX, BY), 0, s>>>(
            (const T*)h[0], (const T*)h[1], (const T*)h[2], (T*)e[0], (T*)e[1], (T*)e[2],
            K, J, I, f, c, ps, l.box);
        return (int)cudaGetLastError();
    }
    e_kernel<T, LOSSY, PML, false><<<l.grid, dim3(BX, BY), 0, s>>>(
        (const T*)h[0], (const T*)h[1], (const T*)h[2], (T*)e[0], (T*)e[1], (T*)e[2],
        K, J, I, f, c, ps, l.box);
    return (int)cudaGetLastError();
}

// the vacuum passes over n members at once (BATCH); gridDim.z = n * (K + 1)
// must stay within 65535 (the wrapper splits larger batches)
template <typename T>
int launch_h_batch(void* const* e, void* const* h, int n, int K, int J, int I, float f, int has_patch, int j0,
                   int j1, int i0, int i1, cudaStream_t s) {
    if (n < 1 || (int64_t)n * (K + 1) > 65535) return (int)cudaErrorInvalidValue;
    Launch l = launch_of(nullptr, K, J, I);
    l.grid.z *= (unsigned)n;
    h_kernel<T, false, false, false, true><<<l.grid, dim3(BX, BY), 0, s>>>(
        (const T*)e[0], (const T*)e[1], (const T*)e[2], (T*)h[0], (T*)h[1], (T*)h[2],
        K, J, I, f, has_patch, j0, j1, i0, i1, Coefs<T>{}, Psi<T>{}, l.box);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_e_batch(void* const* h, void* const* e, int n, int K, int J, int I, float f, cudaStream_t s) {
    if (n < 1 || (int64_t)n * (K + 1) > 65535) return (int)cudaErrorInvalidValue;
    Launch l = launch_of(nullptr, K, J, I);
    l.grid.z *= (unsigned)n;
    e_kernel<T, false, false, false, true><<<l.grid, dim3(BX, BY), 0, s>>>(
        (const T*)h[0], (const T*)h[1], (const T*)h[2], (T*)e[0], (T*)e[1], (T*)e[2],
        K, J, I, f, Coefs<T>{}, Psi<T>{}, l.box);
    return (int)cudaGetLastError();
}

template <typename T, bool SAR>
int launch_ade(void* const* h, void* const* e, void* const* pol, void* const* coefs, void* const* work,
               int K, int J, int I, const int* geom, float dt, cudaStream_t s) {
    if (geom != nullptr) return (int)cudaErrorInvalidValue;
    Ade<T> a{};
    for (int q = 0; q < (SAR ? 18 : 15); ++q) a.c[q] = (const T*)coefs[q];
    if (SAR)
        for (int q = 0; q < 3; ++q) a.w[q] = (float*)work[q];
    a.dt = dt;
    ade_e_kernel<T, SAR><<<launch_of(nullptr, K, J, I).grid, dim3(BX, BY), 0, s>>>(
        (const T*)h[0], (const T*)h[1], (const T*)h[2], (T*)e[0], (T*)e[1], (T*)e[2],
        (T*)pol[0], (T*)pol[1], (T*)pol[2], K, J, I, a);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Each entry point launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a geometry it does not take).
// e, h: three pointers each (x, y, z); coefficient arrays have the fields'
// shape and dtype.  K, J, I: the grid (maxk, maxj, maxi); geom: null for
// arrays of the whole grid, or a shard's 12 ints (see launch_of: the
// arrays' extents, the global index of their origin, the window to
// update, which the arrays must hold with the neighbour planes it reads).
extern "C" {

int yee_update_h(void* ex, void* ey, void* ez, void* hx, void* hy, void* hz,
                 int K, int J, int I, const int* geom, float f,
                 int has_patch, int j0, int j1, int i0, int i1,
                 int dtype, void* stream) {
    void* const e[3] = {ex, ey, ez};
    void* const h[3] = {hx, hy, hz};
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return launch_h<float, false, false>(e, h, K, J, I, geom, f, has_patch, j0, j1, i0, i1, nullptr, nullptr,
                                             nullptr, 0, s);
    if (dtype == 1)
        return launch_h<__nv_bfloat16, false, false>(e, h, K, J, I, geom, f, has_patch, j0, j1, i0, i1, nullptr,
                                                     nullptr, nullptr, 0, s);
    return (int)cudaErrorInvalidValue;
}

// hf: hf_x, hf_y, hf_z
int yee_update_h_het(void* const* e, void* const* h, void* const* hf, int K, int J, int I,
                     const int* geom, int has_patch, int j0, int j1, int i0, int i1, int dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return launch_h<float, true, false>(e, h, K, J, I, geom, 0.f, has_patch, j0, j1, i0, i1, hf, nullptr,
                                            nullptr, 0, s);
    if (dtype == 1)
        return launch_h<__nv_bfloat16, true, false>(e, h, K, J, I, geom, 0.f, has_patch, j0, j1, i0, i1, hf,
                                                     nullptr, nullptr, 0, s);
    return (int)cudaErrorInvalidValue;
}

int yee_update_e(void* hx, void* hy, void* hz, void* ex, void* ey, void* ez,
                 int K, int J, int I, const int* geom, float f, int dtype, void* stream) {
    void* const h[3] = {hx, hy, hz};
    void* const e[3] = {ex, ey, ez};
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) return launch_e<float, false, false>(h, e, K, J, I, geom, f, nullptr, nullptr, nullptr, 0, s);
    if (dtype == 1)
        return launch_e<__nv_bfloat16, false, false>(h, e, K, J, I, geom, f, nullptr, nullptr, nullptr, 0, s);
    return (int)cudaErrorInvalidValue;
}

// cf: ca_x, ca_y, ca_z, cb_x, cb_y, cb_z
int yee_update_e_lossy(void* const* h, void* const* e, void* const* cf, int K, int J, int I,
                       const int* geom, int dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) return launch_e<float, true, false>(h, e, K, J, I, geom, 0.f, cf, nullptr, nullptr, 0, s);
    if (dtype == 1) return launch_e<__nv_bfloat16, true, false>(h, e, K, J, I, geom, 0.f, cf, nullptr, nullptr, 0, s);
    return (int)cudaErrorInvalidValue;
}

// The CPML variants.  psi: the pass's six psi arrays in _TERMS order (see
// Psi; a shard's parts with geom, which then has 42 ints: see launch_of);
// tab: the (6, 2, 2n) (b, c) table; n: the slab depth.  hf and cf as above;
// f is the H factor (vacuum H), the E factor cb (vacuum E).
int yee_update_h_pml(void* const* e, void* const* h, void* const* psi, const void* tab, int n,
                     int K, int J, int I, const int* geom, float f, int has_patch, int j0, int j1, int i0,
                     int i1, int dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n < 1 || psi == nullptr || tab == nullptr) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return launch_h<float, false, true>(e, h, K, J, I, geom, f, has_patch, j0, j1, i0, i1, nullptr, psi, tab,
                                            n, s);
    if (dtype == 1)
        return launch_h<__nv_bfloat16, false, true>(e, h, K, J, I, geom, f, has_patch, j0, j1, i0, i1, nullptr,
                                                    psi, tab, n, s);
    return (int)cudaErrorInvalidValue;
}

int yee_update_h_het_pml(void* const* e, void* const* h, void* const* hf, void* const* psi,
                         const void* tab, int n, int K, int J, int I, const int* geom, int has_patch, int j0,
                         int j1, int i0, int i1, int dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n < 1 || psi == nullptr || tab == nullptr) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return launch_h<float, true, true>(e, h, K, J, I, geom, 0.f, has_patch, j0, j1, i0, i1, hf, psi, tab, n,
                                           s);
    if (dtype == 1)
        return launch_h<__nv_bfloat16, true, true>(e, h, K, J, I, geom, 0.f, has_patch, j0, j1, i0, i1, hf, psi,
                                                   tab, n, s);
    return (int)cudaErrorInvalidValue;
}

int yee_update_e_pml(void* const* h, void* const* e, void* const* psi, const void* tab, int n,
                     int K, int J, int I, const int* geom, float f, int dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n < 1 || psi == nullptr || tab == nullptr) return (int)cudaErrorInvalidValue;
    if (dtype == 0) return launch_e<float, false, true>(h, e, K, J, I, geom, f, nullptr, psi, tab, n, s);
    if (dtype == 1) return launch_e<__nv_bfloat16, false, true>(h, e, K, J, I, geom, f, nullptr, psi, tab, n, s);
    return (int)cudaErrorInvalidValue;
}

int yee_update_e_lossy_pml(void* const* h, void* const* e, void* const* cf, void* const* psi,
                           const void* tab, int n, int K, int J, int I, const int* geom, int dtype,
                           void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n < 1 || psi == nullptr || tab == nullptr) return (int)cudaErrorInvalidValue;
    if (dtype == 0) return launch_e<float, true, true>(h, e, K, J, I, geom, 0.f, cf, psi, tab, n, s);
    if (dtype == 1) return launch_e<__nv_bfloat16, true, true>(h, e, K, J, I, geom, 0.f, cf, psi, tab, n, s);
    return (int)cudaErrorInvalidValue;
}

// The ADE E pass (Debye media).  pol: px, py, pz (the fields' shape and
// dtype, updated in place); coefs: the 15 maps ca_x..k2_z, and with work
// 18 (+ sig_x, sig_y, sig_z); work: null, or three fp32 arrays of the
// fields' shape that receive the edge work; dt: the step rounded to fp32.
int yee_update_e_ade(void* const* h, void* const* e, void* const* pol, void* const* coefs, void* const* work,
                     int K, int J, int I, const int* geom, float dt, int dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (pol == nullptr || coefs == nullptr) return (int)cudaErrorInvalidValue;
    const bool sar = work != nullptr;
    if (dtype == 0)
        return sar ? launch_ade<float, true>(h, e, pol, coefs, work, K, J, I, geom, dt, s)
                   : launch_ade<float, false>(h, e, pol, coefs, work, K, J, I, geom, dt, s);
    if (dtype == 1)
        return sar ? launch_ade<__nv_bfloat16, true>(h, e, pol, coefs, work, K, J, I, geom, dt, s)
                   : launch_ade<__nv_bfloat16, false>(h, e, pol, coefs, work, K, J, I, geom, dt, s);
    return (int)cudaErrorInvalidValue;
}

const char* yee_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// The batched vacuum passes of a sweep: e, h the three fields of member 0
// of (n, K+1, J+1, I+1) contiguous batches; n * (K + 1) <= 65535.
int yee_update_h_batch(void* const* e, void* const* h, int n, int K, int J, int I, float f, int has_patch, int j0,
                       int j1, int i0, int i1, int dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) return launch_h_batch<float>(e, h, n, K, J, I, f, has_patch, j0, j1, i0, i1, s);
    if (dtype == 1) return launch_h_batch<__nv_bfloat16>(e, h, n, K, J, I, f, has_patch, j0, j1, i0, i1, s);
    return (int)cudaErrorInvalidValue;
}

int yee_update_e_batch(void* const* h, void* const* e, int n, int K, int J, int I, float f, int dtype,
                       void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) return launch_e_batch<float>(h, e, n, K, J, I, f, s);
    if (dtype == 1) return launch_e_batch<__nv_bfloat16>(h, e, n, K, J, I, f, s);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
