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
// Two cores carry the passes:
//  - march_kernel, the k-marching core (see "The march core" below): the
//    CPML passes (K10-H, K10-H-het, K10-E, K10-E-lossy) and the vacuum
//    passes (K1, K2), whole grid and shard, and the batched vacuum passes
//    of a sweep (K1-batch, K2-batch: BATCH, the members on blockIdx.y, each
//    member's leads worked out at block start, see member_start);
//  - h_kernel / e_kernel, the first design (one thread per cell, i on
//    threadIdx.x in 64 x 4 blocks, one block row of planes a blockIdx.z,
//    the neighbour reads left to L1 and L2): the het-mu H and lossy E
//    passes (K1-het, K2-lossy), whole grid and shard.  On the march core
//    these measured 0.96-0.98x the first design in fp32 and 0.99-1.00x in
//    bf16 on the whole grid, 1.01x / 1.07x on a shard (python -m
//    fdtd_tpu_torch.tune_twopass, NVIDIA H100 80GB HBM3 at 700 W:
//    PERF.md), not faster in both dtypes, so they keep its machine code.
//
// Cost: each pass reads six fields and writes three, 36 B per cell in fp32
// (18 B in bf16); the material variants read their coefficient arrays once
// more per cell: 48 B (H, het) and 60 B (E, lossy) per cell in fp32; CPML
// reads and writes the psi of the slabs once (about 12 * 2n / N of the
// field state per step).  Every pass is bound by device-memory bytes, not
// by arithmetic.
//
// The march core.  A block owns a tile of BJ x BI = 2 x 128 columns and
// marches a chunk of tk planes (ops/stream_plan.py::march_plan picks tk so
// that every block slot of the card gets a block, in the fewest waves).
// Plane k of the H pass reads E on planes k and k + 1 (the E pass: H on
// k - 1 and k), and its neighbours j + 1, i + 1 (j - 1, i - 1): a tile of
// the other field with a halo row and column on each side, (BJ + 2) x
// (BI + 2) a component and plane, sits in a ring of AH + 2 = 4 planes in
// shared memory, so every element of the other field is read from device
// memory once a chunk (the halo rows and columns come from L2), not twice
// or three times as the first design's neighbour reads may; the pass's own
// field and coefficients of the tile ride a ring of AH + 1 planes beside
// it.  Both are copied with cp.async AH = 2 planes ahead of the update, in
// aligned 16-byte chunks (4 fp32 or 8 bf16 elements; bf16 stays bf16 in
// shared memory and widens at the read): a row of the tile starts where its
// first element falls in its chunk (its lead, from the plane's offset, the
// row's and the arrays' start), so rows of 257 elements need no padding.
// TMA cannot take these arrays: a tensor map needs 16-byte multiples as
// global strides, and a 257-element row is 1028 bytes in fp32 and 514 in
// bf16; padding i would change the port's canonical layout.  A thread
// copies one chunk of one row of every array (worked out once, before the
// march), then updates its column's cell from the shared tiles: all its
// neighbours come from shared memory (a march that kept plane k + 1 in
// registers and moved the i neighbours by warp shuffles, with no shared
// memory and no barrier, measured 0.5-0.6x: at 64 registers a thread it
// held half the card's threads, and its loads a plane at a time).  The
// window's last row and column when they lie one past whole tiles (the H
// pass's row J and column I: 257 = 2 * 128 + 1) go to edge blocks after the
// tiles' blocks, one cell and plane a thread from loads, so no tile block
// carries a serial extra cell.  CPML: a column's bookkeeping is made once
// (MarchCol: per term whether the column holds psi, the offset less its
// plane part, the (b, c) of its j or i slab row); a plane adds the k terms'
// row; the psi of the thread's cell ride a ring of 4-byte words (a bf16
// element in the aligned pair that holds it).  Measured on an NVIDIA H100
// 80GB HBM3 at 700 W (PERF.md; chip_smoke.py against the first design's
// kernels in turns in the same call): the CPML and vacuum passes
// 0.99-1.26x the first design in fp32 and 1.04-1.28x in bf16 (the
// whole-grid het-mu CPML H pass in fp32 a tie), 39-73% of their byte
// bound.  Tried and dropped there (python -m fdtd_tpu_torch.tune_twopass):
// one 4-byte copy an element (the copies' index arithmetic bound the pass),
// 32 x 8 tiles with the extra row and column on their last threads (the
// tile blocks holding them ran twice as long at every barrier), the copy
// descriptors worked out at every plane, a one-thread-per-cell pass with all
// its loads first (its per-cell psi bookkeeping cost more than it saved).
// Tiles and chunks are mirrored by ops/stream_plan.py (march_plan,
// march_counts: the cells each launch updates, tested on the CPU).  The
// batched passes (BATCH) march chunks of at most 6 planes
// (stream_plan.pick_batch_tk): one chunk of each member's planes, which the
// whole-wave rule picks for 256^3 x 4, ran 11-14% slower than 6-plane
// chunks in 87 waves; on the march core they ran 1.16-1.34x the first
// design's batched launch at 256^3 x 4 and 1.14-1.19x at 64^3 x 8
// (tune_twopass --parent, in turns; PERF.md).
//
// Shards (fdtd_tpu_torch/parallel): a launch may update a part of the grid
// held in arrays of its own (a shard's box, halos included): the arrays'
// extents set the strides, and every bound, PEC wall and the source patch
// test global indices, so a shard's owned cells get the operations of the
// whole-grid launch on the same values.  This replaces the leading
// (global-k, global-j) offset operand and `jwin` of the TPU's per-shard
// calls (fdtd_tpu/ops/pallas_fused.py::build_twopass_calls).  The whole
// grid is the box with no offset that owns everything.  The H pass reads
// the halo plane above a shard's window, the E pass the one below.
//
// Numerics: fp32 storage computes in fp32; bf16 storage loads to fp32,
// computes in fp32 and rounds back with __float2bfloat16_rn.  Every operation
// is an explicitly rounded __fsub_rn/__fmul_rn/__fadd_rn in the order of
// ops/curl.py (lossy: ca*E + cb*curl, two products then the sum), and
// coefficients stored in bf16 widen to fp32 exactly, and the library is built with -fmad=false, so the result is
// bit-equal to the plain version on the same card.  Field offsets are
// 64-bit: a 1025^3 array has more than 2^31 elements (psi offsets are
// 32-bit: every psi array holds fewer, which the launch checks).
//
// ADE (plain version: fdtd_tpu_torch/ops/dispersive.py::update_e_ade).
// Replaces fdtd_tpu/ops/pallas_dispersive.py::_e_kernel_ade (the TPU's
// two-pass ADE E pass; its H pass is the vacuum K1).  Per updated edge, from the 15 per-edge maps (ca, cb, cp, k1, k2):
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
// the four adds are skipped there, the recursions still run.  A shard's
// CPML launch (replacing the TPU's per-shard K1/K2 plus XLA slab
// corrections, fdtd_tpu/parallel/sharded_pml_fast.py::
// make_sharded_pml_fast_step) holds its part of each psi array: the slab
// rows whose cells lie in its owned window (ops/cpml.py::psi_part_slices; a
// k slab may straddle two shards, and a shard may hold none of a slab),
// addressed through the part's origin and extents (PsiPart); the canonical
// slab row still picks the (b, c) of the table.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
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

constexpr int BX = 64;  // threads along i
constexpr int BY = 4;   // threads along j

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

// The psi (parts) of a pass (ops/cpml.py::psi_part_slices: a shard holds the
// rows of each term's slab-restricted array whose cells lie in its owned
// window; the whole grid, every row): per term t, its extents e1, e2 along
// axes 1 and 2 and its origin in the canonical array, folded into
// base[t] = (o0 * e1 + o1) * e2 + o2.
struct PsiPart {
    int64_t base[6];
    int e1[6], e2[6];
};

// The part of the grid a launch updates: the arrays hold (nk, nj, ni)
// elements whose local (0, 0, 0) is the global cell (ok, oj, oi), and the
// launch updates the global window [wk0, wk0 + gridDim.z) x [wj0, wj1) x
// [wi0, wi1) (a shard's owned planes; the whole grid: every cell, from 0).
// pp and the kernels' Psi parameter are unused: they keep the parameter
// layout h_kernel and e_kernel had when they carried the CPML passes, which
// the compiler's schedule follows (without them the shard variants'
// machine code changes: python -m fdtd_tpu_torch.sass_compare).
struct Box {
    int nj, ni;      // local extents along j and i (the strides)
    int ok, oj, oi;  // global index of the local origin
    int wk0, wj0, wi0, wj1, wi1;
    PsiPart pp;
};

// the global cell of this thread and its local offset; false outside the
// window.  BOX: a shard's launch, its geometry the runtime box g; without it
// the whole grid's, compiled as it was before shards existed (a runtime box
// in every variant cost the CPML H pass 9-14% at 256^3), so only the shard
// variants carry it.  z: the block's k index in the window (blockIdx.z).
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

// H half-step over Hx k<K, j<J, i<=I; Hy k<K, j<=J, i<I; Hz k<=K, j<J, i<I.
// With has_patch, Hx and Hz at k=0, j0<=j<j1, i0<=i<i1 keep their values
// (the source hard-set there wins, reference main.c:770-778).  HET reads
// the factor of each component from hf.a[0..2] at the cell instead of f.
// (The vacuum and CPML H passes run march_kernel.)
template <typename T, bool HET, bool BOX>
__global__ void __launch_bounds__(BX * BY)
h_kernel(const T* __restrict__ ex, const T* __restrict__ ey, const T* __restrict__ ez,
         T* __restrict__ hx, T* __restrict__ hy, T* __restrict__ hz,
         int K, int J, int I, float f,
         int has_patch, int j0, int j1, int i0, int i1, Coefs<T> hf, Psi<T>, Box g) {
    int k, j, i;
    int64_t c, sj, sk;
    if (!locate<BOX>(g, J, I, blockIdx.z, k, j, i, c, sj, sk)) return;
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
// (The vacuum and CPML E passes run march_kernel.)
template <typename T, bool LOSSY, bool BOX>
__global__ void __launch_bounds__(BX * BY)
e_kernel(const T* __restrict__ hx, const T* __restrict__ hy, const T* __restrict__ hz,
         T* __restrict__ ex, T* __restrict__ ey, T* __restrict__ ez,
         int K, int J, int I, float f, Coefs<T> cf, Psi<T>, Box g) {
    int k, j, i;
    int64_t c, sj, sk;
    if (!locate<BOX>(g, J, I, blockIdx.z, k, j, i, c, sj, sk)) return;

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

// ---------------------------------------------------------------------------
// The k-marching core of the CPML passes (march_kernel; see the header)
// ---------------------------------------------------------------------------

// the row of region coordinate x (region length len) in the 2n-row slab
// layout, or -1 between the slabs
__host__ __device__ __forceinline__ int slab_row(int x, int len, int n) {
    return x < n ? x : (x >= len - n ? x - (len - 2 * n) : -1);
}


// The shape of a march_kernel instantiation: AH, the planes its copies run
// ahead of the update; BJ, a tile's threads along j; NB, the blocks an SM
// holds (__launch_bounds__); BI, its threads along i.  The tiles in shared memory are rows of
// 16-byte chunks (CE elements), each row starting where its first element
// falls in its chunk: the other field's tile of TH x TW elements (a halo row
// and column on each side of the block's columns), and the block's own
// field and coefficients, BJ x BI.
template <typename T, int AH, int BJ, int BI, int NB, int CB>
struct MarchShape {
    static constexpr int NT = BI * BJ;
    static constexpr int CE = CB / (int)sizeof(T);
    static constexpr int TW = BI + 2, TH = BJ + 2;
    static constexpr int CS = (TW + 2 * (CE - 1)) / CE;  // chunks a src row spans at most
    static constexpr int CD = (BI + 2 * (CE - 1)) / CE;  // and a dst row
    static constexpr int WS = CS * CE, WD = CD * CE;     // their widths in elements
    static constexpr int RT = AH + 2;  // src planes in the ring: the two read, AH in flight
    static constexpr int RS = AH + 1;  // dst planes: the one read, AH in flight
    // dynamic shared memory: the src ring, the dst ring (field and coefficients), the psi words
    static constexpr size_t bytes(int nc, int np) {
        return ((size_t)RT * 3 * TH * WS + (size_t)RS * (3 + nc) * BJ * WD) * sizeof(T) + (size_t)RS * np * NT * 4;
    }
};

// A CPML launch: the arrays hold (nk, nj, ni) elements whose local (0, 0, 0)
// is the global cell (ok, oj, oi); the pass updates the global window
// [k0, k1) x [j0, j1) x [i0, i1) (the launch's window within the pass's
// update bounds); ntj x nti tiles of BJ x BI columns cover its columns but
// the last row (column) when xj (xi) is set: the window is then one row
// (column) past whole tiles, and edge blocks update it a cell a thread; a
// tile's block marches tk planes; pp: the psi (parts) of the pass's terms.
struct MarchGeom {
    int nk, nj, ni;
    int ok, oj, oi;
    int k0, k1, j0, j1, i0, i1;
    int ntj, nti, xj, xi;
    int tk;
    int ms, md;  // elements the src and the dst (and coefficient) arrays start past a 16-byte boundary
    PsiPart pp;
};

// A batched launch (BATCH: the members of a sweep, fdtd_tpu_torch/sweep.py)
// runs one pass over N members whose arrays are the contiguous views [b] of
// (N, nk, nj, ni) tensors: member b = blockIdx.y, each member's blocks laid
// out along x as one launch's, so each member gets the operations of the
// whole-grid launch on its own arrays.  It replaces N launches of the pass
// (the JAX package's vmapped _h_kernel2/_e_kernel2 run the batch as one
// program).  Member b's arrays start b * nk * nj * ni elements after member
// 0's (64-bit) ...
__device__ __forceinline__ int64_t member_start(const MarchGeom& g) {
    return (int64_t)blockIdx.y * ((int64_t)g.nk * g.nj * g.ni);
}

// ... and so lie at another offset within 16 bytes: a member's lead (ms, md)
// is member 0's moved by its start, modulo the CE elements of a chunk
// (ops/stream_plan.py::member_lead mirrors it)
__host__ __device__ __forceinline__ int member_lead(int lead0, int64_t start, int ce) {
    return (int)((lead0 + start) & (ce - 1));
}

// the cells of a plane that the edge blocks update: the window's last row
// (xj) and last column (xi), the corner once
__host__ __device__ __forceinline__ int march_edge_cells(const MarchGeom& g) {
    return (g.xj ? g.i1 - g.i0 : 0) + (g.xi ? g.j1 - g.j0 - g.xj : 0);
}

// Term t (0..5, _TERMS order) of the H (e = false) or E pass: its target's
// update region (origin, lengths) and PML axis.  Per target the j/i term is
// t = 2c and the k term 2c + 1, except Hz and Ez, whose two terms are j and i.
struct MarchTerm {
    int k0, j0, i0, Lk, Lj, Li, axis;
};

__host__ __device__ __forceinline__ MarchTerm march_term(bool e, int t, int K, int J, int I) {
    if (!e) {
        switch (t) {
            case 0: return {0, 0, 0, K, J, I + 1, 1};      // hx_y
            case 1: return {0, 0, 0, K, J, I + 1, 0};      // hx_z
            case 2: return {0, 0, 0, K, J + 1, I, 2};      // hy_x
            case 3: return {0, 0, 0, K, J + 1, I, 0};      // hy_z
            case 4: return {0, 0, 0, K + 1, J, I, 1};      // hz_y
            default: return {0, 0, 0, K + 1, J, I, 2};     // hz_x
        }
    }
    switch (t) {
        case 0: return {1, 1, 0, K - 1, J - 1, I, 1};      // ex_y
        case 1: return {1, 1, 0, K - 1, J - 1, I, 0};      // ex_z
        case 2: return {1, 0, 1, K - 1, J, I - 1, 2};      // ey_x
        case 3: return {1, 0, 1, K - 1, J, I - 1, 0};      // ey_z
        case 4: return {0, 1, 1, K, J - 1, I - 1, 2};      // ez_x
        default: return {0, 1, 1, K, J - 1, I - 1, 1};     // ez_y
    }
}

// component c's curl is d[curl_plus] - d[curl_minus] of the pass's six
// differences (term t's difference is d[t]); term t adds (true) or
// subtracts its factor * psi
__host__ __device__ constexpr int curl_plus(bool e, int c) { return e ? (c == 0 ? 0 : c == 1 ? 3 : 4) : (c == 0 ? 1 : c == 1 ? 2 : 4); }
__host__ __device__ constexpr int curl_minus(bool e, int c) { return e ? (c == 0 ? 1 : c == 1 ? 2 : 5) : (c == 0 ? 0 : c == 1 ? 3 : 5); }
__host__ __device__ constexpr bool psi_adds(bool e, int t) { return e ? (t == 0 || t == 3 || t == 4) : (t == 1 || t == 2 || t == 4); }

// What a column (j, i) keeps for the whole march: its offset within a
// plane, the components it updates (their j and i bounds), whether it lies
// in the source patch, and per term whether it can hold psi (j and i terms:
// inside their slab; k terms: inside the target's columns), psi's offset
// less its plane part and, for the j and i terms, the (b, c) of its row.
struct MarchCol {
    int col;
    unsigned upd, pm;
    bool patch;
    int q[6];
    float b[6], c[6];
};

template <typename T, bool E, bool PML>
__device__ __forceinline__ MarchCol march_column(bool live, int j, int i, int K, int J, int I, const MarchGeom& g,
                                                 const Psi<T>& ps, int has_patch, int pj0, int pj1, int pi0,
                                                 int pi1) {
    MarchCol m{};
    if (!live) return m;
    m.col = (j - g.oj) * g.ni + (i - g.oi);
    if constexpr (E)
        m.upd = (j >= 1 && j < J && i < I ? 1u : 0u) | (j < J && i >= 1 && i < I ? 2u : 0u)
                | (j >= 1 && j < J && i >= 1 && i < I ? 4u : 0u);
    else
        m.upd = (j < J ? 1u : 0u) | (i < I ? 2u : 0u) | (j < J && i < I ? 4u : 0u);
    m.patch = !E && has_patch && j >= pj0 && j < pj1 && i >= pi0 && i < pi1;
    if constexpr (PML) {
        const int w = 2 * ps.n;
#pragma unroll
        for (int t = 0; t < 6; ++t) {
            if (!(m.upd >> (t / 2) & 1u)) continue;
            const MarchTerm r = march_term(E, t, K, J, I);
            int c1 = j - r.j0, c2 = i - r.i0, row = 0;
            if (r.axis == 1) c1 = row = slab_row(c1, r.Lj, ps.n);
            if (r.axis == 2) c2 = row = slab_row(c2, r.Li, ps.n);
            if (row < 0) continue;
            m.pm |= 1u << t;
            m.q[t] = (int)((int64_t)c1 * g.pp.e2[t] + c2 - g.pp.base[t]);
            if (r.axis != 0) {
                m.b[t] = ld(ps.tab, 2 * t * w + row);
                m.c[t] = ld(ps.tab, (2 * t + 1) * w + row);
            }
        }
    }
    return m;
}

// an asynchronous copy of element o of `a` into 4-byte shared word w: the
// float itself, or the 4-byte-aligned bf16 pair that holds the element (an
// even element alone, the upper half zero-filled, so no copy reads past it)
__device__ __forceinline__ void fetch(uint32_t* w, const float* a, int64_t o) {
    __pipeline_memcpy_async(w, a + o, 4);
}
__device__ __forceinline__ void fetch(uint32_t* w, const __nv_bfloat16* a, int64_t o) {
    if (o & 1)
        __pipeline_memcpy_async(w, a + (o - 1), 4);
    else
        __pipeline_memcpy_async(w, a + o, 4, 2);
}

// the value of a shared word (odd: the element's index is odd, the pair's
// upper half); bf16 widens exactly by a 16-bit shift
__device__ __forceinline__ float word(uint32_t w, int, const float*) { return __uint_as_float(w); }
__device__ __forceinline__ float word(uint32_t w, int odd, const __nv_bfloat16*) {
    return __uint_as_float(odd ? (w & 0xffff0000u) : (w << 16));
}

// an element of a tile in shared memory, widened
__device__ __forceinline__ float sv(const float* t, int x) { return t[x]; }
__device__ __forceinline__ float sv(const __nv_bfloat16* t, int x) { return __bfloat162float(t[x]); }

// a read-only load (the other field: the pass never writes it)
__device__ __forceinline__ float ldg(const float* p, int64_t o) { return __ldg(p + o); }
__device__ __forceinline__ float ldg(const __nv_bfloat16* p, int64_t o) { return __bfloat162float(__ldg(p + o)); }

// One pass (H: E = false, src = E, dst = H; E: src = H, dst = E), in place.
// A tile's block owns BJ x BI columns and marches its planes [kb0, kb1):
// plane k reads src on planes k + D0 and k + D0 + 1 from a ring of tile
// planes in shared memory (halo rows and columns included), and its cells'
// dst values and coefficients from a ring of tiles of the block's columns,
// all copied in aligned 16-byte chunks with cp.async AH planes ahead, and
// their psi from a ring of words private to each thread (a 4-byte copy
// each).  The edge blocks (blockIdx past the tiles' blocks) update the
// window's last row and column, one cell and plane a thread, from loads.
// MAT: het-mu (H, hf = cf.a) or lossy (E, ca = cf.a, cb = cf.b).  PML: the
// six psi terms of the pass, advanced in place and added.  BATCH (vacuum
// only): a batched launch over the members of a sweep (see member_start).
template <typename T, bool E, bool MAT, bool PML, int AH, int BJ, int BI, int NB, int CB, bool BATCH = false>
__global__ void __launch_bounds__(BI * BJ, NB)
march_kernel(const T* __restrict__ s0, const T* __restrict__ s1, const T* __restrict__ s2, T* __restrict__ d0,
             T* __restrict__ d1, T* __restrict__ d2, int K, int J, int I, float f, int has_patch, int pj0, int pj1,
             int pi0, int pi1, Coefs<T> cf, Psi<T> ps, MarchGeom g) {
    static_assert(!BATCH || (!MAT && !PML), "a batched launch is a vacuum pass");
    using S = MarchShape<T, AH, BJ, BI, NB, CB>;
    constexpr int NT = S::NT, CE = S::CE, TW = S::TW, TH = S::TH, CS = S::CS, CD = S::CD, WS = S::WS, WD = S::WD;
    constexpr int RT = S::RT, RS = S::RS;
    constexpr int D0 = E ? -1 : 0;   // plane k reads src on planes k + D0, k + D0 + 1
    constexpr int RO = E ? 1 : 0;    // a thread's src tile row and column, less (ty, tx)
    constexpr int NC = !MAT ? 0 : E ? 6 : 3;
    constexpr int ND = 3 + NC;       // dst tile arrays: the field, the coefficients
    constexpr int NP = PML ? 6 : 0;
    // a batch member's arrays (BATCH) and their leads; else the launch's (g.ms, g.md)
    int bms = 0, bmd = 0;
    if constexpr (BATCH) {
        const int64_t off = member_start(g);
        s0 += off;
        s1 += off;
        s2 += off;
        d0 += off;
        d1 += off;
        d2 += off;
        bms = member_lead(g.ms, off, CE);
        bmd = member_lead(g.md, off, CE);
    }
    const T* const src[3] = {s0, s1, s2};
    T* const dst[3] = {d0, d1, d2};
    const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * BI + tx;
    const int sj = g.ni, sk = g.nj * g.ni;

    // component c's k bounds; the k terms' slab row at plane k (-1 outside)
    auto kup = [&](int c, int k) -> bool {
        if constexpr (E) return c < 2 ? k >= 1 && k < K : k < K;
        else return c < 2 ? k < K : true;
    };
    auto krow_of = [&](int k) -> int {
        const int kc = k - (E ? 1 : 0), lk = E ? K - 1 : K;
        return kc >= 0 && kc < lk ? slab_row(kc, lk, ps.n) : -1;
    };
    auto psi_live = [&](const MarchCol& m, int t, int k, int krow) -> bool {
        return (m.pm >> t & 1u) && kup(t / 2, k) && ((t != 1 && t != 3) || krow >= 0);
    };
    auto psi_off = [&](const MarchCol& m, int t, int k, int krow) -> int {
        const int c0 = (t == 1 || t == 3) ? krow : k - march_term(E, t, K, J, I).k0;
        return c0 * (g.pp.e1[t] * g.pp.e2[t]) + m.q[t];
    };
    // the (b, c) of the two k terms at row krow
    auto k_terms = [&](int krow, float (&kbc)[4]) {
        kbc[0] = kbc[1] = kbc[2] = kbc[3] = 0.f;
        if (PML && krow >= 0) {
            const int w = 2 * ps.n;
            kbc[0] = ld(ps.tab, 2 * w + krow);
            kbc[1] = ld(ps.tab, 3 * w + krow);
            kbc[2] = ld(ps.tab, 6 * w + krow);
            kbc[3] = ld(ps.tab, 7 * w + krow);
        }
    };
    // the update of cell m at plane k (local offset o) from its six
    // differences d, its dst values u and coefficients (ca, cb: lossy; ca:
    // het-mu); its psi from words pw (NT apart) or, without them, from memory
    auto update = [&](const MarchCol& m, int k, int64_t o, const float (&d)[6], const float (&u)[3],
                      const float (&ca)[3], const float (&cb)[3], const uint32_t* pw, int krow,
                      const float (&kbc)[4]) {
        const unsigned upd = m.upd & ((kup(0, k) ? 1u : 0u) | (kup(1, k) ? 2u : 0u) | (kup(2, k) ? 4u : 0u));
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            if (!(upd >> c & 1u)) continue;
            const float cv = __fsub_rn(d[curl_plus(E, c)], d[curl_minus(E, c)]);
            float v, fac;
            if constexpr (E && MAT) {  // lossy: ca * E + cb * curl, psi adds cb * psi
                fac = cb[c];
                v = __fadd_rn(__fmul_rn(ca[c], u[c]), __fmul_rn(fac, cv));
            } else {
                fac = MAT ? ca[c] : f;  // het-mu: the cell's factor
                v = __fadd_rn(u[c], __fmul_rn(fac, cv));
            }
            if constexpr (PML) {
#pragma unroll
                for (int t = 2 * c; t < 2 * c + 2; ++t) {
                    if (!psi_live(m, t, k, krow)) continue;
                    const int q = psi_off(m, t, k, krow);
                    const float old = pw != nullptr ? word(pw[t * NT], q & 1, (const T*)nullptr) : ld(ps.p[t], q);
                    const bool kt = t == 1 || t == 3;
                    const float b = kt ? kbc[t == 1 ? 0 : 2] : m.b[t], cc = kt ? kbc[t == 1 ? 1 : 3] : m.c[t];
                    const float pn = __fadd_rn(__fmul_rn(b, old), __fmul_rn(cc, d[t]));
                    st(ps.p[t], q, pn);
                    const float corr = __fmul_rn(fac, pn);
                    v = psi_adds(E, t) ? __fadd_rn(v, corr) : __fsub_rn(v, corr);
                }
            }
            // Hx and Hz on the k = 0 source patch keep their values
            if (E || c == 1 || !(m.patch && k == 0)) st(dst[c], o, v);
        }
    };

    const int tiles = g.ntj * g.nti;
    const int planes = g.k1 - g.k0;
    const int main_blocks = tiles * ((planes + g.tk - 1) / g.tk);
    if ((int)blockIdx.x >= main_blocks) {
        // an edge block: cell e of the window's last row and column, plane by plane
        const int ne = march_edge_cells(g);
        const int64_t e = (int64_t)((int)blockIdx.x - main_blocks) * NT + tid;
        if (e >= (int64_t)ne * planes) return;
        const int k = g.k0 + (int)(e / ne), u = (int)(e % ne);
        const int nr = g.xj ? g.i1 - g.i0 : 0;
        const int j = u < nr ? g.j1 - 1 : g.j0 + (u - nr), i = u < nr ? g.i0 + u : g.i1 - 1;
        const MarchCol m = march_column<T, E, PML>(true, j, i, K, J, I, g, ps, has_patch, pj0, pj1, pi0, pi1);
        const int64_t o = (int64_t)(k - g.ok) * sk + m.col;
        // the six differences from loads; a neighbour outside the arrays reads 0 (never used)
        auto in_arrays = [&](int kk, int jj, int ii) {
            return kk - g.ok >= 0 && kk - g.ok < g.nk && jj - g.oj >= 0 && jj - g.oj < g.nj && ii - g.oi >= 0
                   && ii - g.oi < g.ni;
        };
        auto at = [&](int c, int dk, int dj, int di) -> float {
            return in_arrays(k + dk, j + dj, i + di) ? ldg(src[c], o + (int64_t)dk * sk + dj * sj + di) : 0.f;
        };
        float d[6], uu[3], ca[3] = {0.f, 0.f, 0.f}, cb[3] = {0.f, 0.f, 0.f};
        if constexpr (!E) {
            const float ex = at(0, 0, 0, 0), ey = at(1, 0, 0, 0), ez = at(2, 0, 0, 0);
            d[0] = __fsub_rn(at(2, 0, 1, 0), ez);
            d[1] = __fsub_rn(at(1, 1, 0, 0), ey);
            d[2] = __fsub_rn(at(2, 0, 0, 1), ez);
            d[3] = __fsub_rn(at(0, 1, 0, 0), ex);
            d[4] = __fsub_rn(at(0, 0, 1, 0), ex);
            d[5] = __fsub_rn(at(1, 0, 0, 1), ey);
        } else {
            const float hx = at(0, 0, 0, 0), hy = at(1, 0, 0, 0), hz = at(2, 0, 0, 0);
            d[0] = __fsub_rn(hz, at(2, 0, -1, 0));
            d[1] = __fsub_rn(hy, at(1, -1, 0, 0));
            d[2] = __fsub_rn(hz, at(2, 0, 0, -1));
            d[3] = __fsub_rn(hx, at(0, -1, 0, 0));
            d[4] = __fsub_rn(hy, at(1, 0, 0, -1));
            d[5] = __fsub_rn(hx, at(0, 0, -1, 0));
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            uu[c] = ld(dst[c], o);
            if constexpr (MAT) ca[c] = ld(cf.a[c], o);
            if constexpr (E && MAT) cb[c] = ld(cf.b[c], o);
        }
        const int krow = PML ? krow_of(k) : -1;
        float kbc[4];
        k_terms(krow, kbc);
        update(m, k, o, d, uu, ca, cb, nullptr, krow, kbc);
        return;
    }

    extern __shared__ __align__(16) unsigned char smem[];
    T* const stile = reinterpret_cast<T*>(smem);                      // [RT][3][TH][WS]: src planes
    T* const dtile = stile + RT * 3 * TH * WS;                         // [RS][ND][BJ][WD]: dst and coefficients
    uint32_t* const psw = reinterpret_cast<uint32_t*>(dtile + RS * ND * BJ * WD);  // [RS][NP][NT]: psi
    const T* const dsrc[9] = {d0, d1, d2, cf.a[0], cf.a[1], cf.a[2], cf.b[0], cf.b[1], cf.b[2]};

    const int tl = (int)(blockIdx.x % (unsigned)tiles), chunk = (int)(blockIdx.x / (unsigned)tiles);
    const int tj = tl / g.nti, ti = tl - tj * g.nti;
    const int kb0 = g.k0 + chunk * g.tk, kb1 = min(kb0 + g.tk, g.k1);
    const int jt = g.j0 + tj * BJ, it = g.i0 + ti * BI;  // the tile's first column
    const int j = jt + ty, i = it + tx;
    const bool live = j < g.j1 - g.xj && i < g.i1 - g.xi;
    const MarchCol m0 = march_column<T, E, PML>(live, j, i, K, J, I, g, ps, has_patch, pj0, pj1, pi0, pi1);

    // where element 0 of a src (dst) row (plane offset po, row offset rowoff) starts within its chunk
    auto lead = [&](int64_t po, int rowoff) -> int {
        if constexpr (BATCH) return (int)((po + rowoff + bms) & (CE - 1));
        return (int)((po + rowoff + g.ms) & (CE - 1));
    };
    auto dlead = [&](int64_t po, int rowoff) -> int {
        if constexpr (BATCH) return (int)((po + rowoff + bmd) & (CE - 1));
        return (int)((po + rowoff + g.md) & (CE - 1));
    };
    // the chunk this thread copies each plane, worked out once: thread x <
    // TH * CS copies chunk x % CS of src tile row x / CS of the three
    // components, thread NT - 1 - x < BJ * CD chunk x % CD of dst tile row
    // x / CD of the ND arrays; its row offset within a plane, its place in a
    // ring slot and its first column (rows outside the arrays copy nothing)
    static_assert(TH * CS <= NT && BJ * CD <= NT, "a tile row's chunks exceed the block");
    const int sx = tid, dx = NT - 1 - tid;
    const bool scopy = sx < TH * CS && jt - RO + sx / CS - g.oj >= 0 && jt - RO + sx / CS - g.oj < g.nj;
    const bool dcopy = dx < BJ * CD && jt + dx / CD - g.oj < g.nj;
    const int sro = (jt - RO + sx / CS - g.oj) * sj + (it - RO - g.oi), scx = (sx % CS) * CE;
    const int sso = (sx / CS) * WS + scx;
    const int dro = (jt + dx / CD - g.oj) * sj + (it - g.oi), dcx = (dx % CD) * CE;
    const int dso = (dx / CD) * WD + dcx;
    // the columns of the src tile (from it - RO) and of the dst tile (from it) inside the arrays
    const int sxlo = max(0, g.oi - (it - RO)), sxhi = min(TW, g.ni + g.oi - (it - RO));
    const int dxhi = min(BI, g.ni + g.oi - it);
    auto load_src = [&](int q, int b) {
        const int lq = q - g.ok;
        if (lq < 0 || lq >= g.nk || !scopy) return;
        const int64_t po = (int64_t)lq * sk;
        const int ld_ = lead(po, sro);
        if (scx - ld_ < sxhi && scx + CE - ld_ > sxlo) {
            T* const w = stile + b * 3 * TH * WS + sso;
            const int64_t o = po + sro - ld_ + scx;
#pragma unroll
            for (int c = 0; c < 3; ++c) __pipeline_memcpy_async(w + c * TH * WS, src[c] + o, CB);
        }
    };
    auto load_dst = [&](int k, int s) {
        const int64_t po = (int64_t)(k - g.ok) * sk;
        if (dcopy) {
            const int ld_ = dlead(po, dro);
            if (dcx - ld_ < dxhi && dcx + CE - ld_ > 0) {
                T* const w = dtile + s * ND * BJ * WD + dso;
                const int64_t o = po + dro - ld_ + dcx;
#pragma unroll
                for (int a = 0; a < ND; ++a) __pipeline_memcpy_async(w + a * BJ * WD, dsrc[a] + o, CB);
            }
        }
        if constexpr (PML) {
            if (live) {
                const int kr = krow_of(k);
#pragma unroll
                for (int t = 0; t < 6; ++t)
                    if (psi_live(m0, t, k, kr)) fetch(psw + (s * NP + t) * NT + tid, ps.p[t], psi_off(m0, t, k, kr));
            }
        }
    };
    // the thread's own rows: src rows r0 and rn (H: r0 + 1; E: r0 - 1), its dst row
    const int r0 = ty + RO, x0 = tx + RO, rn = E ? r0 - 1 : r0 + 1;
    const int ro0 = (jt - RO + r0 - g.oj) * sj + (it - RO - g.oi), ron = ro0 + (E ? -sj : sj);
    const int rod = (jt + ty - g.oj) * sj + (it - g.oi);

    // the pipeline: group d of copies holds plane kb0 + d's dst tile and the
    // src plane kb0 + D0 + 1 + d (group 0 also plane kb0 + D0); at plane k the
    // copies of plane k + AH are issued
    load_src(kb0 + D0, 0);
#pragma unroll
    for (int d = 0; d < AH; ++d) {
        if (kb0 + d < kb1) {
            load_src(kb0 + D0 + 1 + d, 1 + d);
            load_dst(kb0 + d, d);
        }
        __pipeline_commit();
    }
    int tb = 0, sl = 0;  // the ring slots of src plane k + D0 and of plane k
    for (int k = kb0; k < kb1; ++k) {
        __pipeline_wait_prior(AH - 1);
        __syncthreads();  // plane k's copies are in; every thread is past plane k - 1
        if (k + AH < kb1) {
            const int nb = tb + 1 + AH, ns = sl + AH;
            load_src(k + D0 + 1 + AH, nb >= RT ? nb - RT : nb);
            load_dst(k + AH, ns >= RS ? ns - RS : ns);
        }
        __pipeline_commit();
        const int b0 = tb, b1 = tb + 1 >= RT ? tb + 1 - RT : tb + 1;
        if (live) {
            // the src rows on planes k + D0 (b0) and k + D0 + 1 (b1)
            const int64_t p0 = (int64_t)(k + D0 - g.ok) * sk, p1 = p0 + sk;
            auto row = [&](int b, int c, int r, int64_t po) {
                return stile + ((b * 3 + c) * TH + r) * WS + lead(po, r == r0 ? ro0 : ron);
            };
            float d[6];
            if constexpr (!E) {  // E on planes k (b0) and k + 1 (b1)
                const T* x0r = row(b0, 0, r0, p0);
                const T* y0r = row(b0, 1, r0, p0);
                const T* z0r = row(b0, 2, r0, p0);
                const float ex = sv(x0r, x0), ey = sv(y0r, x0), ez = sv(z0r, x0);
                d[0] = __fsub_rn(sv(row(b0, 2, rn, p0), x0), ez);  // hx_y: Ez along j
                d[1] = __fsub_rn(sv(row(b1, 1, r0, p1), x0), ey);  // hx_z: Ey along k
                d[2] = __fsub_rn(sv(z0r, x0 + 1), ez);             // hy_x: Ez along i
                d[3] = __fsub_rn(sv(row(b1, 0, r0, p1), x0), ex);  // hy_z: Ex along k
                d[4] = __fsub_rn(sv(row(b0, 0, rn, p0), x0), ex);  // hz_y: Ex along j
                d[5] = __fsub_rn(sv(y0r, x0 + 1), ey);             // hz_x: Ey along i
            } else {  // H on planes k - 1 (b0) and k (b1)
                const T* x1r = row(b1, 0, r0, p1);
                const T* y1r = row(b1, 1, r0, p1);
                const T* z1r = row(b1, 2, r0, p1);
                const float hx = sv(x1r, x0), hy = sv(y1r, x0), hz = sv(z1r, x0);
                d[0] = __fsub_rn(hz, sv(row(b1, 2, rn, p1), x0));  // ex_y: Hz along j
                d[1] = __fsub_rn(hy, sv(row(b0, 1, r0, p0), x0));  // ex_z: Hy along k
                d[2] = __fsub_rn(hz, sv(z1r, x0 - 1));             // ey_x: Hz along i
                d[3] = __fsub_rn(hx, sv(row(b0, 0, r0, p0), x0));  // ey_z: Hx along k
                d[4] = __fsub_rn(hy, sv(y1r, x0 - 1));             // ez_x: Hy along i
                d[5] = __fsub_rn(hx, sv(row(b1, 0, rn, p1), x0));  // ez_y: Hx along j
            }
            // the cell's dst values and coefficients from the dst tile
            const int64_t pk = (int64_t)(k - g.ok) * sk;
            const int dl = dlead(pk, rod);
            const T* dt = dtile + (sl * ND * BJ + ty) * WD + dl + tx;
            float uu[3], ca[3] = {0.f, 0.f, 0.f}, cb[3] = {0.f, 0.f, 0.f};
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                uu[c] = sv(dt, c * BJ * WD);
                if constexpr (MAT) ca[c] = sv(dt, (3 + c) * BJ * WD);
                if constexpr (E && MAT) cb[c] = sv(dt, (6 + c) * BJ * WD);
            }
            const int krow = PML ? krow_of(k) : -1;
            float kbc[4];
            k_terms(krow, kbc);
            update(m0, k, pk + m0.col, d, uu, ca, cb, PML ? psw + sl * NP * NT + tid : nullptr, krow, kbc);
        }
        tb = b1;
        sl = sl + 1 >= RS ? sl + 1 - RS : sl + 1;
    }
}

// geom: null (the whole grid) or 12 ints: the arrays' extents (nk, nj, ni),
// the global index of their origin (ok, oj, oi) and the window to update
// (wk0, wk1, wj0, wj1, wi0, wi1), global
struct Launch {
    Box box;
    dim3 grid;
};

Launch launch_of(const int* geom, int K, int J, int I) {
    Launch l{};
    if (geom == nullptr) {
        l.box = Box{J + 1, I + 1, 0, 0, 0, 0, 0, 0, J + 1, I + 1};
        l.grid = dim3((unsigned)((I + 1 + BX - 1) / BX), (unsigned)((J + 1 + BY - 1) / BY), (unsigned)(K + 1));
        return l;
    }
    l.box = Box{geom[1], geom[2], geom[3], geom[4], geom[5], geom[6], geom[8], geom[10], geom[9], geom[11]};
    l.grid = dim3((unsigned)((geom[11] - geom[10] + BX - 1) / BX), (unsigned)((geom[9] - geom[8] + BY - 1) / BY),
                  (unsigned)(geom[7] - geom[6]));
    return l;
}

// a window inside the arrays and the grid, with a neighbour plane on each
// side that is not a wall of the grid (the halos the passes read)
bool valid_geom(const int* geom, int K, int J, int I) {
    if (geom == nullptr) return true;
    const int n[3] = {K + 1, J + 1, I + 1};
    for (int a = 0; a < 3; ++a) {
        const int ext = geom[a], org = geom[3 + a], lo = geom[6 + 2 * a], hi = geom[7 + 2 * a];
        if (ext < 1 || lo < 0 || hi > n[a] || lo >= hi) return false;
        if (org > std::max(lo - 1, 0) || org + ext < std::min(hi + 1, n[a])) return false;
    }
    return true;
}

// the het-mu H pass on h_kernel (hf: hf_x, hf_y, hf_z)
template <typename T>
int launch_h_het(void* const* e, void* const* h, int K, int J, int I, const int* geom, int has_patch, int j0,
                 int j1, int i0, int i1, void* const* hf, cudaStream_t s) {
    if (!valid_geom(geom, K, J, I)) return (int)cudaErrorInvalidValue;
    Coefs<T> c{};
    for (int q = 0; q < 3; ++q) c.a[q] = (const T*)hf[q];
    const Launch l = launch_of(geom, K, J, I);
    if (geom != nullptr) {
        h_kernel<T, true, true><<<l.grid, dim3(BX, BY), 0, s>>>(
            (const T*)e[0], (const T*)e[1], (const T*)e[2], (T*)h[0], (T*)h[1], (T*)h[2],
            K, J, I, 0.f, has_patch, j0, j1, i0, i1, c, Psi<T>{}, l.box);
        return (int)cudaGetLastError();
    }
    h_kernel<T, true, false><<<l.grid, dim3(BX, BY), 0, s>>>(
        (const T*)e[0], (const T*)e[1], (const T*)e[2], (T*)h[0], (T*)h[1], (T*)h[2],
        K, J, I, 0.f, has_patch, j0, j1, i0, i1, c, Psi<T>{}, l.box);
    return (int)cudaGetLastError();
}

// the lossy E pass on e_kernel (cf: ca_x, ca_y, ca_z, cb_x, cb_y, cb_z)
template <typename T>
int launch_e_lossy(void* const* h, void* const* e, int K, int J, int I, const int* geom, void* const* cf,
                   cudaStream_t s) {
    if (!valid_geom(geom, K, J, I)) return (int)cudaErrorInvalidValue;
    Coefs<T> c{};
    for (int q = 0; q < 3; ++q) {
        c.a[q] = (const T*)cf[q];
        c.b[q] = (const T*)cf[3 + q];
    }
    const Launch l = launch_of(geom, K, J, I);
    if (geom != nullptr) {
        e_kernel<T, true, true><<<l.grid, dim3(BX, BY), 0, s>>>(
            (const T*)h[0], (const T*)h[1], (const T*)h[2], (T*)e[0], (T*)e[1], (T*)e[2],
            K, J, I, 0.f, c, Psi<T>{}, l.box);
        return (int)cudaGetLastError();
    }
    e_kernel<T, true, false><<<l.grid, dim3(BX, BY), 0, s>>>(
        (const T*)h[0], (const T*)h[1], (const T*)h[2], (T*)e[0], (T*)e[1], (T*)e[2],
        K, J, I, 0.f, c, Psi<T>{}, l.box);
    return (int)cudaGetLastError();
}

// A march launch's geom: the 12 ints of a box (launch_of; the whole grid
// is the box of its own extents from 0), per term of the pass the origin
// (o0, o1, o2) of its psi part in the canonical array and the part's
// extents (e1, e2) along axes 1 and 2 (30 ints), and the planes a block
// marches (ops/stream_plan.py::march_plan).  False for a geometry the
// kernel does not take: a window outside the arrays, negative psi parts,
// or psi arrays of 2^31 elements or more (the kernel's psi offsets are
// 32-bit).
bool march_geom(const int* geom, int K, int J, int I, bool e, int n, int bj, int bi, MarchGeom& g) {
    if (geom == nullptr || !valid_geom(geom, K, J, I) || geom[42] < 1) return false;
    for (int q = 12; q < 42; ++q)
        if (geom[q] < 0) return false;
    for (int t = 0; t < 6; ++t) {
        const MarchTerm r = march_term(e, t, K, J, I);
        int64_t len[3] = {r.Lk, r.Lj, r.Li};
        len[r.axis] = 2 * n;
        if (len[0] * len[1] * len[2] >= ((int64_t)1 << 31)) return false;
    }
    g.nk = geom[0];
    g.nj = geom[1];
    g.ni = geom[2];
    g.ok = geom[3];
    g.oj = geom[4];
    g.oi = geom[5];
    // the window within the pass's update bounds: H k <= K, j <= J, i <= I; E k < K, j < J, i < I
    g.k0 = geom[6];
    g.k1 = std::min(geom[7], e ? K : K + 1);
    g.j0 = geom[8];
    g.j1 = std::min(geom[9], e ? J : J + 1);
    g.i0 = geom[10];
    g.i1 = std::min(geom[11], e ? I : I + 1);
    // tiles of bj x bi columns; a window one row (column) past whole tiles leaves it to the edge blocks
    auto tiles = [](int ext, int b, int& nt, int& x) {
        nt = std::max(1, (ext - 1 + b - 1) / b);
        x = nt * b < ext ? 1 : 0;
    };
    tiles(g.j1 - g.j0, bj, g.ntj, g.xj);
    tiles(g.i1 - g.i0, bi, g.nti, g.xi);
    g.tk = geom[42];
    for (int t = 0; t < 6; ++t) {
        const int* q = geom + 12 + 5 * t;
        g.pp.e1[t] = q[3];
        g.pp.e2[t] = q[4];
        g.pp.base[t] = ((int64_t)q[0] * q[3] + q[1]) * q[4] + q[2];
    }
    return true;
}

// The shape every CPML pass is built at (MarchShape; ops/stream_plan.py::
// MARCH_BJ and MARCH_BLOCKS_PER_SM mirror it)
constexpr int MARCH_AH = 2, MARCH_BJ = 2, MARCH_BI = 128, MARCH_NB = 4, MARCH_CB = 16;

// a batched launch's members lie along gridDim.y
constexpr int MARCH_MEMBERS = 65535;
// The shapes of the batched passes (ops/stream_plan.py::MARCH_BATCH_WIDE
// and MARCH_BATCH_NARROW), measured with tune_twopass on an NVIDIA H100
// 80GB HBM3 at 700 W (PERF.md): wide members run the single passes' 2 x
// 128 tiles with their copies three planes ahead (2% faster than two at
// 256^3 x 4 in both dtypes); narrow members 4 x 64 tiles two planes ahead,
// where 128-wide ones leave lanes idle (a 65-wide member of a 64^3 sweep
// fills half a 128-wide tile: 1.3-1.4x in bf16 at 64^3 x 8, a tie to 1.08x
// in fp32; slower at 256^3 x 4)
constexpr int BATCH_WIDE_AH = 3;
constexpr int BATCH_NARROW_BJ = 4, BATCH_NARROW_BI = 64;

// whether a batch member's window of `width` columns takes the narrow
// tiles: fewer lanes a row than the 128-wide tiles (march_geom's tiles;
// ops/stream_plan.py::batch_is_narrow mirrors it)
bool batch_narrow(int width) {
    auto lanes = [&](int b) { return std::max(1, (width - 1 + b - 1) / b) * b; };
    return lanes(BATCH_NARROW_BI) < lanes(MARCH_BI);
}

// one pass on march_kernel: src the other field, dst the pass's, in place;
// mat: hf (H) or ca, cb (E) with MAT; psi: the pass's six psi (parts) with
// PML; with BATCH over `members` members (src and dst: member 0's arrays)
template <typename T, bool E, bool MAT, bool PML, int AH = MARCH_AH, int BJ = MARCH_BJ, int BI = MARCH_BI,
          int NB = MARCH_NB, int CB = MARCH_CB, bool BATCH = false>
int launch_march(void* const* src, void* const* dst, int K, int J, int I, const int* geom, float f, int has_patch,
                 int j0, int j1, int i0, int i1, void* const* mat, void* const* psi, const void* tab, int n,
                 cudaStream_t s, int members = 1) {
    MarchGeom g{};
    if (!march_geom(geom, K, J, I, E, n, BJ, BI, g)) return (int)cudaErrorInvalidValue;
    if (members < 1 || members > MARCH_MEMBERS || (!BATCH && members != 1)) return (int)cudaErrorInvalidValue;
    if (g.k1 <= g.k0 || g.j1 <= g.j0 || g.i1 <= g.i0) return (int)cudaSuccess;  // nothing to update
    Coefs<T> c{};
    if (MAT)
        for (int q = 0; q < 3; ++q) {
            c.a[q] = (const T*)mat[q];
            if (E) c.b[q] = (const T*)mat[3 + q];
        }
    Psi<T> ps{};
    if (PML)
        for (int q = 0; q < 6; ++q) ps.p[q] = (T*)psi[q];
    ps.tab = (const T*)tab;
    ps.n = n;
    // the copies move aligned 16-byte chunks: the src arrays must start alike
    // within 16 bytes, and so must the dst and coefficient arrays (a sweep
    // member's views of (N, K+1, J+1, I+1) batches do; a batch's other
    // members start alike too, each at its member_lead)
    const uintptr_t s16 = (uintptr_t)src[0] % 16, d16 = (uintptr_t)dst[0] % 16;
    for (int q = 0; q < 3; ++q) {
        if ((uintptr_t)src[q] % 16 != s16 || (uintptr_t)dst[q] % 16 != d16) return (int)cudaErrorMisalignedAddress;
        if (MAT && ((uintptr_t)c.a[q] % 16 != d16 || (E && (uintptr_t)c.b[q] % 16 != d16)))
            return (int)cudaErrorMisalignedAddress;
    }
    if (s16 % sizeof(T) != 0 || d16 % sizeof(T) != 0) return (int)cudaErrorMisalignedAddress;
    g.ms = (int)(s16 / sizeof(T));
    g.md = (int)(d16 / sizeof(T));
    const int planes = g.k1 - g.k0;
    const int64_t blocks = (int64_t)g.ntj * g.nti * ((planes + g.tk - 1) / g.tk)
                           + ((int64_t)march_edge_cells(g) * planes + BI * BJ - 1) / (BI * BJ);
    auto kernel = march_kernel<T, E, MAT, PML, AH, BJ, BI, NB, CB, BATCH>;
    const size_t dyn = MarchShape<T, AH, BJ, BI, NB, CB>::bytes(!MAT ? 0 : E ? 6 : 3, PML ? 6 : 0);
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3((unsigned)blocks, (unsigned)members), dim3(BI, BJ), dyn, s>>>(
        (const T*)src[0], (const T*)src[1], (const T*)src[2], (T*)dst[0], (T*)dst[1], (T*)dst[2], K, J, I, f,
        has_patch, j0, j1, i0, i1, c, ps, g);
    return (int)cudaGetLastError();
}

// the vacuum passes of n members at once (E: the E pass) on the march core
// with BATCH, at shape (AH, BJ, BI, NB, CB)
template <typename T, bool E, int AH, int BJ, int BI, int NB, int CB>
int launch_batch_at(void* const* src, void* const* dst, int n, int K, int J, int I, const int* geom, float f,
                    int has_patch, int j0, int j1, int i0, int i1, cudaStream_t s) {
    return launch_march<T, E, false, false, AH, BJ, BI, NB, CB, true>(src, dst, K, J, I, geom, f, has_patch, j0, j1,
                                                                     i0, i1, nullptr, nullptr, nullptr, 1, s, n);
}

// ... at the wide shape, or the narrow one for narrow members
template <typename T, bool E>
int launch_batch(void* const* src, void* const* dst, int n, int K, int J, int I, const int* geom, float f,
                 int has_patch, int j0, int j1, int i0, int i1, cudaStream_t s) {
    if (geom == nullptr) return (int)cudaErrorInvalidValue;
    if (batch_narrow(std::min(geom[11], E ? I : I + 1) - geom[10]))
        return launch_batch_at<T, E, MARCH_AH, BATCH_NARROW_BJ, BATCH_NARROW_BI, MARCH_NB, MARCH_CB>(
            src, dst, n, K, J, I, geom, f, has_patch, j0, j1, i0, i1, s);
    return launch_batch_at<T, E, BATCH_WIDE_AH, MARCH_BJ, MARCH_BI, MARCH_NB, MARCH_CB>(
        src, dst, n, K, J, I, geom, f, has_patch, j0, j1, i0, i1, s);
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

#ifdef YEE_TWOPASS_CANDIDATES
// The march core at other shapes, with and without CPML (for python -m
// fdtd_tpu_torch.tune_twopass, which times them against the built CPML
// passes and against h_kernel / e_kernel): shape q of (AH, BJ, BI, NB)
// and CB, the bytes a copy moves: {(2, 2, 128, 3, 16), (3, 2, 128, 3, 16),
// (2, 2, 128, 4, 16), (2, 1, 256, 4, 16), (3, 2, 128, 4, 16)};
// pass 0 = H (src
// e, dst h, mat hf or null), 1 = E (src h, dst e, mat ca, cb or null);
// psi null: no CPML (geom's psi parts unused); geom's tk picked for the
// shape.
template <typename T, bool E, bool MAT, bool PML>
int march_shape(int q, void* const* src, void* const* dst, int K, int J, int I, const int* geom, float f,
                int has_patch, int j0, int j1, int i0, int i1, void* const* mat, void* const* psi, const void* tab,
                int n, cudaStream_t s) {
#define YEE_SHAPE(AH, BJ, BI, NB, CB) \
    return launch_march<T, E, MAT, PML, AH, BJ, BI, NB, CB>(src, dst, K, J, I, geom, f, has_patch, j0, j1, i0, \
                                                           i1, mat, psi, tab, n, s)
    switch (q) {
        case 0: YEE_SHAPE(2, 2, 128, 3, 16);
        case 1: YEE_SHAPE(3, 2, 128, 3, 16);
        case 2: YEE_SHAPE(2, 2, 128, 4, 16);
        case 3: YEE_SHAPE(2, 1, 256, 4, 16);
        case 4: YEE_SHAPE(3, 2, 128, 4, 16);
        default: return (int)cudaErrorInvalidValue;
    }
#undef YEE_SHAPE
}

// The batched vacuum passes at a shape forced whatever the members' width
// (tune_twopass): shape q of (AH, BJ, BI, NB, CB) {(2, 2, 128, 4, 16) the
// single passes', (2, 4, 64, 4, 16) the narrow, (3, 2, 128, 4, 16) the
// wide, (3, 4, 64, 4, 16)}
template <typename T, bool E>
int batch_shape(int q, void* const* src, void* const* dst, int n, int K, int J, int I, const int* geom, float f,
                int has_patch, int j0, int j1, int i0, int i1, cudaStream_t s) {
#define YEE_SHAPE(AH, BJ, BI, NB, CB) \
    return launch_batch_at<T, E, AH, BJ, BI, NB, CB>(src, dst, n, K, J, I, geom, f, has_patch, j0, j1, i0, i1, s)
    switch (q) {
        case 0: YEE_SHAPE(2, 2, 128, 4, 16);
        case 1: YEE_SHAPE(2, 4, 64, 4, 16);
        case 2: YEE_SHAPE(3, 2, 128, 4, 16);
        case 3: YEE_SHAPE(3, 4, 64, 4, 16);
        default: return (int)cudaErrorInvalidValue;
    }
#undef YEE_SHAPE
}

template <typename T>
int march_candidate(int q, int pass, void* const* src, void* const* dst, void* const* mat, void* const* psi,
                    const void* tab, int n, int K, int J, int I, const int* geom, float f, int has_patch, int j0,
                    int j1, int i0, int i1, cudaStream_t s) {
    const bool m = mat != nullptr, p = psi != nullptr;
#define YEE_CAND(E, MAT, PML) \
    return march_shape<T, E, MAT, PML>(q, src, dst, K, J, I, geom, f, has_patch, j0, j1, i0, i1, mat, psi, tab, n, s)
    if (pass == 0 && !m && !p) YEE_CAND(false, false, false);
    if (pass == 0 && m && !p) YEE_CAND(false, true, false);
    if (pass == 0 && !m && p) YEE_CAND(false, false, true);
    if (pass == 0 && m && p) YEE_CAND(false, true, true);
    if (pass == 1 && !m && !p) YEE_CAND(true, false, false);
    if (pass == 1 && m && !p) YEE_CAND(true, true, false);
    if (pass == 1 && !m && p) YEE_CAND(true, false, true);
    if (pass == 1 && m && p) YEE_CAND(true, true, true);
#undef YEE_CAND
    return (int)cudaErrorInvalidValue;
}
#endif

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

// The vacuum passes run march_kernel: geom is never null, the 43 ints of
// march_geom (its psi parts zero).
int yee_update_h(void* ex, void* ey, void* ez, void* hx, void* hy, void* hz,
                 int K, int J, int I, const int* geom, float f,
                 int has_patch, int j0, int j1, int i0, int i1,
                 int dtype, void* stream) {
    void* const e[3] = {ex, ey, ez};
    void* const h[3] = {hx, hy, hz};
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return launch_march<float, false, false, false>(e, h, K, J, I, geom, f, has_patch, j0, j1, i0, i1, nullptr,
                                                        nullptr, nullptr, 1, s);
    if (dtype == 1)
        return launch_march<__nv_bfloat16, false, false, false>(e, h, K, J, I, geom, f, has_patch, j0, j1, i0, i1,
                                                                nullptr, nullptr, nullptr, 1, s);
    return (int)cudaErrorInvalidValue;
}

// hf: hf_x, hf_y, hf_z
int yee_update_h_het(void* const* e, void* const* h, void* const* hf, int K, int J, int I,
                     const int* geom, int has_patch, int j0, int j1, int i0, int i1, int dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) return launch_h_het<float>(e, h, K, J, I, geom, has_patch, j0, j1, i0, i1, hf, s);
    if (dtype == 1) return launch_h_het<__nv_bfloat16>(e, h, K, J, I, geom, has_patch, j0, j1, i0, i1, hf, s);
    return (int)cudaErrorInvalidValue;
}

int yee_update_e(void* hx, void* hy, void* hz, void* ex, void* ey, void* ez,
                 int K, int J, int I, const int* geom, float f, int dtype, void* stream) {
    void* const h[3] = {hx, hy, hz};
    void* const e[3] = {ex, ey, ez};
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return launch_march<float, true, false, false>(h, e, K, J, I, geom, f, 0, 0, 0, 0, 0, nullptr, nullptr,
                                                       nullptr, 1, s);
    if (dtype == 1)
        return launch_march<__nv_bfloat16, true, false, false>(h, e, K, J, I, geom, f, 0, 0, 0, 0, 0, nullptr,
                                                               nullptr, nullptr, 1, s);
    return (int)cudaErrorInvalidValue;
}

// cf: ca_x, ca_y, ca_z, cb_x, cb_y, cb_z
int yee_update_e_lossy(void* const* h, void* const* e, void* const* cf, int K, int J, int I,
                       const int* geom, int dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) return launch_e_lossy<float>(h, e, K, J, I, geom, cf, s);
    if (dtype == 1) return launch_e_lossy<__nv_bfloat16>(h, e, K, J, I, geom, cf, s);
    return (int)cudaErrorInvalidValue;
}

// The CPML variants, on march_kernel.  psi: the pass's six psi arrays in
// _TERMS order (a shard's parts; see Psi); tab: the (6, 2, 2n) (b, c)
// table; n: the slab depth; geom: never null, the 43 ints of march_geom
// (the whole grid's box too).  hf and cf as above; f is the H factor
// (vacuum H), the E factor cb (vacuum E).
int yee_update_h_pml(void* const* e, void* const* h, void* const* psi, const void* tab, int n,
                     int K, int J, int I, const int* geom, float f, int has_patch, int j0, int j1, int i0,
                     int i1, int dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n < 1 || psi == nullptr || tab == nullptr) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return launch_march<float, false, false, true>(e, h, K, J, I, geom, f, has_patch, j0, j1, i0, i1, nullptr,
                                                       psi, tab, n, s);
    if (dtype == 1)
        return launch_march<__nv_bfloat16, false, false, true>(e, h, K, J, I, geom, f, has_patch, j0, j1, i0, i1,
                                                               nullptr, psi, tab, n, s);
    return (int)cudaErrorInvalidValue;
}

int yee_update_h_het_pml(void* const* e, void* const* h, void* const* hf, void* const* psi,
                         const void* tab, int n, int K, int J, int I, const int* geom, int has_patch, int j0,
                         int j1, int i0, int i1, int dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n < 1 || psi == nullptr || tab == nullptr) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return launch_march<float, false, true, true>(e, h, K, J, I, geom, 0.f, has_patch, j0, j1, i0, i1, hf, psi,
                                                      tab, n, s);
    if (dtype == 1)
        return launch_march<__nv_bfloat16, false, true, true>(e, h, K, J, I, geom, 0.f, has_patch, j0, j1, i0, i1,
                                                              hf, psi, tab, n, s);
    return (int)cudaErrorInvalidValue;
}

int yee_update_e_pml(void* const* h, void* const* e, void* const* psi, const void* tab, int n,
                     int K, int J, int I, const int* geom, float f, int dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n < 1 || psi == nullptr || tab == nullptr) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return launch_march<float, true, false, true>(h, e, K, J, I, geom, f, 0, 0, 0, 0, 0, nullptr, psi, tab, n, s);
    if (dtype == 1)
        return launch_march<__nv_bfloat16, true, false, true>(h, e, K, J, I, geom, f, 0, 0, 0, 0, 0, nullptr, psi,
                                                              tab, n, s);
    return (int)cudaErrorInvalidValue;
}

int yee_update_e_lossy_pml(void* const* h, void* const* e, void* const* cf, void* const* psi,
                           const void* tab, int n, int K, int J, int I, const int* geom, int dtype,
                           void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n < 1 || psi == nullptr || tab == nullptr) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return launch_march<float, true, true, true>(h, e, K, J, I, geom, 0.f, 0, 0, 0, 0, 0, cf, psi, tab, n, s);
    if (dtype == 1)
        return launch_march<__nv_bfloat16, true, true, true>(h, e, K, J, I, geom, 0.f, 0, 0, 0, 0, 0, cf, psi, tab,
                                                             n, s);
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

// The batched vacuum passes of a sweep, on march_kernel with BATCH: e, h
// the three fields of member 0 of n contiguous (n, K+1, J+1, I+1) batches,
// 1 <= n <= 65535 (gridDim.y); geom: the 43 ints of march_geom of a
// member's whole grid, its chunk depth picked for n members
// (ops/stream_plan.py::march_plan); narrow members take 4 x 64 tiles.
int yee_update_h_batch(void* const* e, void* const* h, int n, int K, int J, int I, const int* geom, float f,
                       int has_patch, int j0, int j1, int i0, int i1, int dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) return launch_batch<float, false>(e, h, n, K, J, I, geom, f, has_patch, j0, j1, i0, i1, s);
    if (dtype == 1)
        return launch_batch<__nv_bfloat16, false>(e, h, n, K, J, I, geom, f, has_patch, j0, j1, i0, i1, s);
    return (int)cudaErrorInvalidValue;
}

int yee_update_e_batch(void* const* h, void* const* e, int n, int K, int J, int I, const int* geom, float f,
                       int dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) return launch_batch<float, true>(h, e, n, K, J, I, geom, f, 0, 0, 0, 0, 0, s);
    if (dtype == 1) return launch_batch<__nv_bfloat16, true>(h, e, n, K, J, I, geom, f, 0, 0, 0, 0, 0, s);
    return (int)cudaErrorInvalidValue;
}

#ifdef YEE_TWOPASS_CANDIDATES
int yee_march_candidate(int shape, int pass, void* const* src, void* const* dst, void* const* mat, void* const* psi,
                        const void* tab, int n, int K, int J, int I, const int* geom, float f, int has_patch, int j0,
                        int j1, int i0, int i1, int dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (psi != nullptr && (n < 1 || tab == nullptr)) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return march_candidate<float>(shape, pass, src, dst, mat, psi, tab, psi ? n : 1, K, J, I, geom, f, has_patch,
                                      j0, j1, i0, i1, s);
    if (dtype == 1)
        return march_candidate<__nv_bfloat16>(shape, pass, src, dst, mat, psi, tab, psi ? n : 1, K, J, I, geom, f,
                                              has_patch, j0, j1, i0, i1, s);
    return (int)cudaErrorInvalidValue;
}

// the batched vacuum passes at shape q of batch_shape (pass 0 = H, 1 = E)
int yee_march_batch_candidate(int shape, int pass, void* const* src, void* const* dst, int n, int K, int J, int I,
                              const int* geom, float f, int has_patch, int j0, int j1, int i0, int i1, int dtype,
                              void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
#define YEE_BATCH(T, E) return batch_shape<T, E>(shape, src, dst, n, K, J, I, geom, f, has_patch, j0, j1, i0, i1, s)
    if (dtype == 0 && pass == 0) YEE_BATCH(float, false);
    if (dtype == 0 && pass == 1) YEE_BATCH(float, true);
    if (dtype == 1 && pass == 0) YEE_BATCH(__nv_bfloat16, false);
    if (dtype == 1 && pass == 1) YEE_BATCH(__nv_bfloat16, true);
#undef YEE_BATCH
    return (int)cudaErrorInvalidValue;
}
#endif

}  // extern "C"
