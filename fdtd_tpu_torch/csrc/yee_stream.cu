// Streaming multi-step Yee sweep for Hopper (sm_90a): one launch advances a
// closed PEC cavity by S in {8, 4, 2} leapfrog steps.
//
// Replaces the TPU kernel fdtd_tpu/ops/pallas_stream.py::_kernel on a
// single device: vacuum in both modes, and its material variants in
// computation mode: lossy media (six ca/cb arrays, E = ca*E + cb*curl H),
// heterogeneous mu_r (three hf arrays for the H update) and the SAR
// accumulator (sigma*|E_cell|^2*dt of every step added to an fp32 map).
// With PML it replaces fdtd_tpu/ops/pallas_stream_pml.py::_kernel_pml
// (vacuum and lossy): the twelve CPML memory variables ride the pipeline
// (see "CPML" below).  With ADE it replaces
// fdtd_tpu/ops/pallas_dispersive.py::_kernel_ade_stream (Debye media,
// vacuum H; see "ADE" below).  With DFT each of these variants carries the
// DFT bands of the three TPU kernels (see "DFT" below).  The plain version is
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
// Materials.  The E update of level m on plane k reads ca/cb at (k, j, i),
// the H update hf at (k, j, i), straight from device memory (each plane's
// coefficients are read once per level, S times in S consecutive pipeline
// steps, so the repeats hit L1/L2).  SAR: the cell mean of cell (k, j, i)
// reads level m's E on planes k and k+1 and at j+1, i+1.  Level m's E on
// plane k+1 appears at pipeline step k+1+m, beside its plane k (still in
// the registers; level S keeps one extra E plane for it), and a third
// shared exchange (5 values per column) gives the j+1 / i+1 neighbours.
// That read reaches one column past E's validity, so SAR tiles emit one
// column fewer per axis, (BJ-2S-1) x (BI-2S-1), and the pipeline runs one
// step further so that level S reaches plane k1.  Each emitted cell is
// owned by one thread: it loads the accumulator at level 1, adds level
// 1..S's increments in level order in a register shift chain (one slot
// per level in flight) and stores it at level S, so the map is updated in
// place, without atomics, in the order of S per-step increments.
// Lead-in planes and halo columns add nothing.
//
// CPML.  psi is the slab-restricted layout of fdtd_tpu_torch/ops/cpml.py
// (twelve arrays, each its target's update region with 2n rows along its
// PML axis).  The recursion psi^m = b psi^(m-1) + c d^m is pointwise, so
// psi moves through the levels like a field: level m reads level m-1's psi
// of its plane k (the value from the previous pipeline step, as eo/ho are)
// and level S stores the emitted cells'.  d^m is the curl's own difference
// of level m's inputs (the sourced views for m >= 2), and per target the
// adds follow ops/cpml.py::_TERMS (curl, j/i term(s), k term), each
// rounded; on the source patch the Hx/Hz adds are skipped while their
// recursions run (the hard-set wins, as in the two-pass kernels).  Halo
// columns and lead-in planes recompute psi and never store it.  A
// neighbouring block's halo reads level-0 psi of cells this block writes,
// so a sweep reads one psi set and writes a second.  Where no term has psi
// the arithmetic is the vacuum (or lossy) sweep's, in its order, so a
// block whose recompute region holds no psi may run K3's code: see "The
// CPML sweep on the Hopper core" below.
//
// ADE (Debye media).  The E update of level m on plane k is the ADE update
// of yee_twopass.cu::ade_e_kernel: E' = ((ca*E + cb*curl) + cp*P) and
// P' = k1*P + k2*(E' + E) from the 15 per-edge maps (read per level and
// plane like the lossy ca/cb); H is the vacuum update.  P is pointwise, so
// it needs no shared exchange: the three P of a column ride a register
// chain like eo/ho (pl[m]: level m's newest plane; level 1 reads level 0's
// from the input, level S stores the emitted cells'), and a sweep reads one
// P set and writes a second (a neighbour's halo reads level-0 P of cells
// this block writes).  SAR: each level's edge work w = E_mid*((P' - P)/dt +
// sig*E_mid) of its plane (0 off the update bounds) is kept for one more
// pipeline step (wl[m]), and the cell mean of cell k-1 takes level m's w on
// planes k-1 and k with their j+1 / i+1 neighbours through the third shared
// exchange, in the association of ops/dispersive.py::work_cell_means
// (per component 0.25*(((a+b)+c)+d), then (mx+my)+mz, then acc + inc*dt).
// The accumulator is owned and updated as in the lossy SAR variant, so fp32
// gives the two-pass path's bits, SAR map included.  The TPU's j-tiled
// in-place variant (_build_ade_stream_call_jt) has no counterpart: this
// kernel always tiles j and i with a recompute halo.
//
// DFT (the E phasor sums of fields "e").  Level m's E cell means are formed
// as the E-mean SAR variant forms them (E on planes k-1 and k with their
// j+1 / i+1 neighbours through the third shared exchange; level S keeps
// one more E plane; tiles one column narrower, the pipeline one step
// longer), and the thread that owns a cell adds level m's increments for
// every frequency f, re += cw[m][f] * E_c and im -= sw[m][f] * E_c, to the
// canonical (nf, nc, K, J, I) fp32 sums, so the S increments of a cell land
// in step order.  The 6*nf sums of the S cells a thread has in flight live
// in dynamic shared memory (slot cell % S, one chain per thread, so no
// barrier guards it; nf is a runtime value, up to what fits beside the
// static buffers: ops/stream_plan.py::StreamPlan.dft_max_nf): level 1's
// sums are fetched with cp.async at the start of the pipeline step (their
// latency hides behind the level's H and E updates), level S stores them.
// (A read, add and write-back of the sums in device memory at every level
// measured 1.7-4x slower: each level waits on the load behind the previous
// level's store.)  The weights are the sweep's (S, 2, nf) fp32 rows on the device.  With the
// Debye SAR (whose exchange carries the work) the E values take the same
// shared buffer after the work means have read it.  fp32 gives the per-step
// accumulation's bits (fdtd_tpu_torch/dft.py::accumulate after each
// two-pass step).
//
// The means mode of the DFT instantiations (FOLD, launched where a means
// buffer is given: ops/stream_plan.py::StreamPlan.fold) takes every
// frequency count: the thread that owns a cell stores level m's three E
// cell means, fp32, into level m-1 of a (S, 3, cells) slice of a buffer in
// device memory (the cell box's layout, so the stores are coalesced along
// i) and touches no sums and no shared memory for them; dft_accum.cu's fold
// adds the buffered levels to the sums later, in step order, reading and
// writing the sums once a fold instead of once a step.  It is a template
// flag, not a branch: a run-time branch on the buffer's pointer in the
// bands' instantiations cost their sweeps up to 6% at 256^3 (registers and
// spills moved; PERF.md), and with the flag they keep their machine
// code.  Its instantiations are a build of this source of their own
// (-DYEE_STREAM_FOLD: the entry point takes the means mode alone, the
// default build everything else), so that the two compile in parallel.
// It runs at the bands' shapes (wider tiles, which its shared memory
// would allow, measured slower at 256^3 in fp32), and the lossy CPML
// sweep's shell and interior take the coefficient ring the bands have no
// room for.  Storing each level's E instead of its cell means, for the fold
// to average (no cell-mean column, exchange or barrier here), made these
// sweeps up to 1.28x faster but a fold on E levels 2-3x slower, a loss a
// step, so the cell means stay (PERF.md).
//
// Shards (fdtd_tpu_torch/parallel; replaces the TPU's per-shard calls
// fdtd_tpu/ops/pallas_stream.py::build_stream_shard_call and its j-tiled
// form _build_stream_shard_call_jt).  A sweep may advance a part of the
// grid held in arrays of its own (Box below): the arrays' extents set the
// strides, every bound, wall, source and drive test reads global indices,
// and the blocks emit only the shard's owned window.  A shard's arrays
// hold S halo planes (S+1 with the cell means) on each side it shares with
// a neighbour, copied in before the sweep, so a shard is one more k
// segment whose lead-in and top read the halo planes, and on a sharded j
// side its tiles' recompute halo reads the halo rows; the level-S values
// of the owned window are those of the whole-grid sweep, bit for bit.  The
// SAR map and the DFT sums of a shard cover its owned cells (the cell box):
// with the bands a shard's sweep replaces build_stream_shard_call(dft_nf > 0)
// (fdtd_tpu/parallel/sharded_fast.py::make_sharded_stream_dft_runner), on
// 1-D and 2-D meshes.  The whole grid is the box with no offset that owns
// everything.
//
// Cost: the sweep reads each field once per halo-amplified tile and writes
// it once: 48 B per cell per S steps in fp32 before amplification (24 B in
// bf16), against 72 B per step for the two-pass kernels.  Lossy media add
// 24 B of ca/cb reads per cell per sweep (fp32), het-mu 12 B of hf, SAR
// 4 B of sigma and 8 B of accumulator read and write.
//
// Two kernels carry the design above: ring_kernel (K3, every variant, and
// K12) and pml_kernel (the shell of the CPML sweep, K11), both on the
// Hopper core below.
//
// The Hopper core.  Bytes did not bind the sweep's first version (plain
// per-thread loads at the top of each pipeline step, coefficients read
// from memory at every level, a grid of tk-plane k segments, two
// block-wide exchanges per level): at 256^3 its own traffic model needed
// 23-38% of the time it took.  One 768-1024-thread block fills an SM and
// drains at every barrier, so whatever a thread waits for, the SM waits
// for.  The core does four things about it:
//  - Planes loaded ahead: a ring in dynamic shared memory, one 4-byte word
//    per thread and array (thread-private, so it needs no barrier of its
//    own).  The fields (and P) of plane r+1 and, with CR, the coefficients
//    of plane r (ca/cb, hf, SAR sigma and the map value of cell r-1; the
//    Debye maps) are copied with cp.async after level 1's first barrier of
//    step r, so a step's S levels hide the loads' latency.  Coefficients
//    keep S+1 planes (plane k is read at levels 1..S, steps k+1..k+S), so
//    every level reads them from shared memory and memory sees them once
//    per tile plane (the material sweep's s = 8 shape, whose S+1 planes
//    would not fit, reads them from memory).  TMA cannot take these
//    rows (a 257-element row is not a 16-B multiple, and padding i would
//    change the layout), so the copies are 4-byte LDGSTS, coalesced along
//    i.  A bf16 row is staged whole by its warp (one j row of 32
//    consecutive i): the 16 or 17 aligned words that cover the in-box
//    elements, one copy a lane from the first lanes, into the first slots
//    of the warp's 32-slot row (a span that ends on an even element
//    zero-fills that word's upper half, so no copy reads past an array);
//    each lane reads its element as a half-word at an offset fixed once a
//    plane, after a __syncwarp.  The first bf16 form copied each lane's
//    own aligned pair (an odd element's pair, an even one alone: two
//    divergent copies a warp, each word asked for twice) and picked the
//    half by parity at every read: K3-lossy-SAR took 2.226 ms a 4-step
//    sweep at 256^3 against fp32's 1.610; staged, 1.927 (PERF.md).
//  - i neighbours by warp shuffles (the tile's i extent is one warp), so
//    only the j neighbours (Ex, Ez up; Hx, Hz down; three values of the
//    cell means) cross warps through shared memory.  A halo lane reads its
//    own value where the first version read 0; the recompute halo discards
//    both.
//  - Whole waves: block b advances segment b / tiles of tile b % tiles, so
//    the blocks of a wave walk neighbouring tiles' planes together and the
//    halo columns they share come from L2; the segment count is the one
//    whose waves take the fewest pipeline steps an SM
//    (ops/stream_plan.py::pick_tk: 121 whole tiles in one wave at 256^3 in
//    vacuum, 648 blocks in 4.9 waves with SAR).  A persistent grid of one
//    block an SM walking the (tile, plane) list in equal runs filled every
//    SM to the end but put neighbouring tiles at different planes, so their
//    halo columns came from device memory: 1.5-2.2x slower, dropped.
//  - Less work a level: 32-bit column offsets with one 64-bit plane offset
//    where memory is touched, coefficient reads from the ring at a
//    thread-private address, the map value's load from the ring.
// What binds each variant now (PERF.md): vacuum and the CPML-free
// material sweeps reach 26-36% of their byte bound at s = 4 (the halo
// re-reads and the per-level instruction stream, 8 barriers a step); the
// s = 2 sweeps (Debye, the material DFT bands) 45-56%.  Of the vacuum
// step's 318 instructions between its barriers, 103 are the update's
// arithmetic; the rest are bound tests, shared-memory and shuffle traffic
// and kernel parameters reloaded from the constant bank (64 registers at
// 1024 threads).  Tried, each bit for bit, and dropped (no faster in fp32
// at 256^3; python -m fdtd_tpu_torch.tune_stream, same call against this
// design): two blocks an SM (launch bounds (512, 2): 1.2-1.3x
// slower, the smaller tile's halo); one barrier a level (the next level's
// E inputs published with this level's H, the cell means a barrier late:
// -5%..+10%, so the barriers' tails do not bind); a block-uniform fast path
// without the bound tests for interior tiles and planes (the step body
// twice: vacuum spilled 60 B and ran 0.73x, the rest 0.95-1.06x); the
// fields loaded two planes ahead (0.92-1.04x: one plane hides the loads).
// The rest is the first version's arithmetic, in its order, so the results
// are its results bit for bit.
//
// The CPML sweep on the Hopper core (K11; ops/stream_plan.py::pml_blocks).
// psi's bytes are the slab volume read and written once a sweep (63 MB at
// 256^3 fp32 with 10-cell walls, 0.04 ms at the card's rate), so work and
// registers bind the CPML sweep, and the first version paid for psi in
// every cell: twelve psi a level in registers at 768 threads (s = 4 and 8
// spilled), per-term index work at every level, plane and term.  Most
// cells hold none.  A sweep is two launches over disjoint emitted windows:
//  - the interior window, whose blocks' recompute regions (the tile with
//    its s-column halo, s + 1 with the DFT cell means, and the segment with
//    its lead-in and tail planes) hold no psi, runs ring_kernel's box
//    instantiation of the variant without CPML: K3's arithmetic, which is
//    the CPML arithmetic there, so the bits are the same;
//  - the six boxes around it (the k slabs, the j slabs between them, the i
//    slabs between those; the j and i slabs a whole tile wide) run
//    pml_kernel from a block list, each entry a block's planes and emitted
//    columns.
// pml_kernel is the core above with psi: level 0's twelve psi of the plane
// level 1 reads next ride the ring (copied with the next plane's fields,
// only the terms the column holds there), levels 1..S-1 keep theirs in
// registers (S = 2: twelve), the (b, c) tables sit in shared memory as
// one pair a term and row, and a per-column mask of the terms a column can
// hold, anded once a plane with the terms whose k range admits it, gates
// every term's work.  Measured at 256^3 fp32 (PERF.md): 0.83 ms a
// sweep against the first version's 1.46, the shell 62% of it at about
// 2.2x the interior's time a thread and step.  One launch of pml_kernel on
// every block, the psi work skipped by a block-uniform flag where a block's
// region holds none, measured 1.16 (its psi-free blocks ran about 2.2x K3's
// time), and the shell at 640, 512 or 1024 threads, or at s = 4, ran
// slower: dropped.
//
// Numerics: every operation is an explicitly rounded __fsub_rn / __fmul_rn /
// __fadd_rn in the order of ops/curl.py, built with -fmad=false, so fp32 is
// bit-equal to S steps of the two-pass kernels and of the plain torch
// steps (with SAR: and their per-step increments).  bf16 storage loads to
// fp32, keeps every level in fp32 and rounds once per sweep, at the store;
// coefficients and sigma stored in bf16 widen to fp32, and the SAR of a
// bf16 sweep comes from its fp32 levels.  ring_kernel reads each bf16
// value as a half-word of its warp's staged row and widens it by a 16-bit
// shift, exactly, so the staging moves no bit: at 256^3 the bf16 sweeps
// ran x1.02-1.37 a sweep against the per-lane pairs, bit for bit (K3-DFT
// x0.98, at 80 registers with 32 B of spills; tune_stream --dtypes
// bfloat16 --parent, PERF.md).  Offsets into device memory are
// 64-bit (ring_kernel: a 64-bit plane offset plus a 32-bit column offset).

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

// 0.25 * (((a + b) + c) + d): a 4-edge cell mean, as diagnostics.py sums it
__device__ __forceinline__ float mean4(float a, float b, float c, float d) {
    return __fmul_rn(0.25f, __fadd_rn(__fadd_rn(__fadd_rn(a, b), c), d));
}

// the row of region coordinate x (region length len) in the 2n-row slab
// layout, or -1 between the slabs
__device__ __forceinline__ int slab_row(int x, int len, int n) {
    return x < n ? x : (x >= len - n ? x - (len - 2 * n) : -1);
}

// The region of term t of ops/cpml.py::_TERMS (hx_y, hx_z, hy_x, hy_z,
// hz_y, hz_x, ex_y, ex_z, ey_x, ey_z, ez_x, ez_y): its target's update
// region, origin (k0, j0, i0) and lengths (Lk, Lj, Li), and its PML axis
struct TermRegion {
    int k0, j0, i0, Lk, Lj, Li, axis;
};

__device__ __forceinline__ TermRegion term_region(int t, int K, int J, int I) {
    switch (t) {
        case 0: return {0, 0, 0, K, J, I + 1, 1};          // hx_y
        case 1: return {0, 0, 0, K, J, I + 1, 0};          // hx_z
        case 2: return {0, 0, 0, K, J + 1, I, 2};          // hy_x
        case 3: return {0, 0, 0, K, J + 1, I, 0};          // hy_z
        case 4: return {0, 0, 0, K + 1, J, I, 1};          // hz_y
        case 5: return {0, 0, 0, K + 1, J, I, 2};          // hz_x
        case 6: return {1, 1, 0, K - 1, J - 1, I, 1};      // ex_y
        case 7: return {1, 1, 0, K - 1, J - 1, I, 0};      // ex_z
        case 8: return {1, 0, 1, K - 1, J, I - 1, 2};      // ey_x
        case 9: return {1, 0, 1, K - 1, J, I - 1, 0};      // ey_z
        case 10: return {0, 1, 1, K, J - 1, I - 1, 2};     // ez_x
        default: return {0, 1, 1, K, J - 1, I - 1, 1};     // ez_y
    }
}

// whether column (j, i) can hold psi of term t: inside the term's region in
// j and i and, for a j- or i-axis term, inside its slabs (a per-thread bit)
__device__ __forceinline__ bool psi_column(int t, int j, int i, int K, int J, int I, int n) {
    const TermRegion g = term_region(t, K, J, I);
    const int lj = j - g.j0, li = i - g.i0;
    if (lj < 0 || lj >= g.Lj || li < 0 || li >= g.Li) return false;
    if (g.axis == 1) return slab_row(lj, g.Lj, n) >= 0;
    if (g.axis == 2) return slab_row(li, g.Li, n) >= 0;
    return true;
}

// term t's slab row at cell (k, j, i) of its region: along its PML axis,
// -1 between the slabs
__device__ __forceinline__ int psi_row(int t, int k, int j, int i, int K, int J, int I, int n) {
    const TermRegion g = term_region(t, K, J, I);
    return g.axis == 0 ? slab_row(k - g.k0, g.Lk, n)
                       : g.axis == 1 ? slab_row(j - g.j0, g.Lj, n) : slab_row(i - g.i0, g.Li, n);
}

// the offset of that cell (slab row `row`) in term t's array: 32-bit, as
// the wrapper checks every psi array holds fewer than 2^31 elements
__device__ __forceinline__ int psi_offset(int t, int k, int j, int i, int K, int J, int I, int n, int row) {
    const TermRegion g = term_region(t, K, J, I);
    const int lk = k - g.k0, lj = j - g.j0, li = i - g.i0;
    if (g.axis == 0) return (row * g.Lj + lj) * g.Li + li;
    if (g.axis == 1) return (lk * 2 * n + row) * g.Li + li;
    return (lk * g.Lj + lj) * 2 * n + row;
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

// the arrays of the material variants (null where a variant does not read them)
template <typename T>
struct Material {
    const T* ca[3];     // lossy: ca_x, ca_y, ca_z, the fields' shape
    const T* cb[3];     // lossy: cb_x, cb_y, cb_z
    const T* hf[3];     // het: hf_x, hf_y, hf_z
    const T* sigma;     // SAR: (K, J, I) cell conductivity
    float* acc;         // SAR: (K, J, I) fp32 accumulator, updated in place
    float dt;           // SAR: the step, rounded to fp32
};

// the ADE variants' arrays: the 15 maps (ca, cb, cp, k1, k2, each x, y, z;
// the fields' shape and dtype) and with SAR the three edge sigma maps (c[15..17]);
// the input and output polarization sets
template <typename T>
struct AdeSweep {
    const T* c[18];
    const T* pin[3];
    T* pout[3];
};

// d / dt, correctly rounded: an IEEE division, except that a zero d (every
// edge where P does not change, most of a scene) returns itself, which is
// what the division gives for a positive dt, without the division's slow
// special-case path
__device__ __forceinline__ float div_dt(float d, float dt) { return d == 0.f ? d : __fdiv_rn(d, dt); }

// the CPML variants' psi: the input and output sets, twelve arrays each in
// _TERMS order, and the (b, c) tables of the H and E terms, (6, 2, 2n) each
template <typename T>
struct PsiSweep {
    const T* in[12];
    T* out[12];
    const T* tab[2];  // H, E
    int n;            // slab depth in cells
};

// the DFT variants' sums and weights: re, im (nf, nc, K, J, I) fp32, updated
// in place (components 0..2); w: the sweep's (S, 2, nf) fp32 rows.  The
// means mode: mb, the sweep's (S, 3, cells) fp32 slice of the means buffer
// (re, im and w null, nf 0)
struct DftSweep {
    float* re;
    float* im;
    const float* w;
    int nf;
    int nc;
    float* mb;
};

// The part of the grid a sweep advances: the arrays hold (nk, nj, ni)
// elements whose local (0, 0, 0) is the global cell (ok, oj, oi); the
// blocks emit the global window [wk0, wk1) x [wj0, wj1) x [wi0, wi1); the
// SAR map and DFT sums hold the cells from (ck0, cj0, ci0), (cnk, cnj, cni)
// of them (a shard's owned cells; the whole grid: every cell, from 0).
struct Box {
    int nj, ni;
    int ok, oj, oi;
    int wk0, wk1, wj0, wj1, wi0, wi1;
    int ck0, cj0, ci0, cnk, cnj, cni;
};

// ---------------------------------------------------------------------------
// The Hopper core of K3 and K12 (ring_kernel; see "The Hopper core" above)
// ---------------------------------------------------------------------------

// a copy of element o of `a` into this thread's 4-byte ring word: the float
// itself, or the 4-byte-aligned bf16 pair that holds the element (an even
// element alone, the upper half zero-filled, so no copy reads past it);
// ring_kernel's bf16 copies stage whole rows instead (stage(), below), and
// pml_kernel's sparse psi copies keep these
__device__ __forceinline__ void fetch(uint32_t* w, const float* a, int64_t o) {
    __pipeline_memcpy_async(w, a + o, 4);
}
__device__ __forceinline__ void fetch(uint32_t* w, const __nv_bfloat16* a, int64_t o) {
    if (o & 1)
        __pipeline_memcpy_async(w, a + (o - 1), 4);
    else
        __pipeline_memcpy_async(w, a + o, 4, 2);
}

// the value of a ring word (odd: the element's index is odd, so it is the
// pair's upper half); bf16 widens exactly by a 16-bit shift
__device__ __forceinline__ float word(uint32_t w, int, const float*) { return __uint_as_float(w); }
__device__ __forceinline__ float word(uint32_t w, int odd, const __nv_bfloat16*) {
    return __uint_as_float(odd ? (w & 0xffff0000u) : (w << 16));
}

// ring_kernel's bf16 rows (a warp is one j row of 32 consecutive i): the
// warp's in-box elements of an array's row, at most 64 bytes from a
// 2-byte-aligned start, are staged as the 16 or 17 aligned words that cover
// them, one 4-byte copy a lane from the first lanes, into the first slots of
// the warp's 32-slot row of the ring; each lane reads its element as a
// half-word of the staged row.  A row's lanes: `col`, the offset of the first
// in-box lane's element within its plane (or cell plane); `n`, the in-box
// lanes (contiguous; 0: the row lies outside the arrays); `rel`, this lane's
// element past the first (0 outside the box, a harmless in-row read).
struct StagedRow {
    int col, n, rel;
};

__device__ __forceinline__ StagedRow staged_row(bool in, int col) {
    const unsigned m = __ballot_sync(0xffffffffu, in);
    const int first = __ffs(m) - 1;
    return {__shfl_sync(0xffffffffu, col, first & 31), __popc(m), in ? (int)threadIdx.x - first : 0};
}

// lane `lane`'s copy into the staged row `row` of the n elements of `a` from
// element o: word lane of those that cover them.  A span that ends on an even
// element zero-fills the last word's upper half, so no copy reads past it.
template <typename T>
__device__ __forceinline__ void stage(uint32_t* row, const T* a, int64_t o, int n, int lane) {
    const int odd = (int)(o & 1), words = (odd + n + 1) >> 1;
    if (lane < words) {
        const int bytes = lane == words - 1 && ((odd + n) & 1) ? 2 : 4;
        const unsigned dst = (unsigned)__cvta_generic_to_shared(row + lane);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                     "l"(reinterpret_cast<const uint32_t*>(a) + (o >> 1) + lane), "r"(bytes)
                     : "memory");
    }
}

// a staged row's half-words, and a bf16 value from its 16 bits (widening
// to fp32 is exact, a 16-bit shift)
__device__ __forceinline__ const unsigned short* halves(const uint32_t* row) {
    return reinterpret_cast<const unsigned short*>(row);
}
__device__ __forceinline__ float widen(unsigned short b) { return __uint_as_float((uint32_t)b << 16); }

// one edge's ADE update (component q) from its coefficients, its inputs eo,
// po and the curl cv: returns E', sets pn and, with W, the edge work w
template <bool W>
__device__ __forceinline__ float ade_update(float ca, float cb, float cp, float k1, float k2, float sig, float eo,
                                           float po, float cv, float dt, float& pn, float& w) {
    const float en = __fadd_rn(__fadd_rn(__fmul_rn(ca, eo), __fmul_rn(cb, cv)), __fmul_rn(cp, po));
    pn = __fadd_rn(__fmul_rn(k1, po), __fmul_rn(k2, __fadd_rn(en, eo)));
    if (W) {
        const float em = __fmul_rn(0.5f, __fadd_rn(en, eo));
        w = __fmul_rn(em, __fadd_rn(div_dt(__fsub_rn(pn, po), dt), __fmul_rn(sig, em)));
    }
    return en;
}

// The shape of a ring_kernel instantiation: tiles, and the ring's words a
// thread (NF fields and P of the next plane; with CR, NC coefficient words
// of each of the last S + 1 planes: lossy ca/cb, het hf, SAR sigma and the
// map value of the cell below, or the Debye maps and the map value).
template <int S, int BJ, bool CR, bool LOSSY, bool HET, bool SAR, bool ADE, bool DFT>
struct RingGeom {
    static constexpr bool MEANS = SAR || DFT;
    static constexpr int SH = MEANS ? 1 : 0;
    static constexpr int TJ = BJ - 2 * S - SH;
    static constexpr int TI = BI - 2 * S - SH;
    static constexpr int NT = BI * BJ;
    static constexpr int NF = ADE ? 9 : 6;
    static constexpr int C_SIG = 6 + (HET ? 3 : 0);
    static constexpr int C_ACC = ADE ? 18 : C_SIG + 1;
    static constexpr int NC = !CR ? 0 : ADE ? (SAR ? 19 : 15) : !LOSSY ? 0 : SAR ? C_SIG + 2 : C_SIG;
    static constexpr int NCS = NC > 0 ? S + 1 : 0;
    static constexpr int WORDS = (NF + NCS * NC) * NT;
};

constexpr unsigned FULL = 0xffffffffu;

// BOX: a shard's sweep, its geometry the runtime Box g; without it the
// whole grid's (a runtime box in every variant cost some of them 5-14% at
// 256^3, through registers, spills and the instruction stream), so only
// the shard variants carry it.  FOLD (with DFT): the bands' means mode, whose
// levels a fold kernel adds to the sums.
template <typename T, int S, int BJ, bool CR, bool LOSSY, bool HET, bool SAR, bool ADE, bool DFT, bool BOX,
          bool FOLD = false>
__global__ void __launch_bounds__(BI * BJ, 1)
ring_kernel(Fields<T> in, OutFields<T> out, int K, int J, int I, float fh, float fe, int tk, int has_patch, int j0,
            int j1, int i0, int i1, const T* __restrict__ ez_rows, const T* __restrict__ hx_rows, Material<T> mat,
            AdeSweep<T> ade, DftSweep dft, Box g) {
    using G = RingGeom<S, BJ, CR, LOSSY, HET, SAR, ADE, DFT>;
    constexpr bool MEANS = G::MEANS;
    constexpr int SH = G::SH, TJ = G::TJ, TI = G::TI, NT = G::NT, NC = G::NC, NCS = G::NCS;
    static_assert(TJ >= 1 && TI >= 1, "the block is too small for S steps");
    __shared__ float sE[2][BJ][BI];  // level m-1's Ex, Ez on plane k: the j+1 reads
    __shared__ float sH[2][BJ][BI];  // level m's Hx, Hz on plane k: the j-1 reads
    // SAR / DFT: the j+1 reads of the cell means: level m's Ex (Debye SAR:
    // work) on planes k-1 and k, Ez on plane k-1
    __shared__ float sS[MEANS ? 3 : 1][MEANS ? BJ : 1][BI];
    extern __shared__ uint32_t ring[];
    uint32_t* const rf = ring;            // [NF][NT]: the next plane's fields (and P)
    uint32_t* const rc = ring + G::NF * NT;  // [NCS][NC][NT]: coefficients of planes k % NCS
    // DFT: the sums of the S cells in flight, slot (cell % S) of this thread:
    // sD[(slot * 6 * nf + q) * NT + tid], q = 6f + 2c + (0: re, 1: im)
    float* const sD = reinterpret_cast<float*>(ring + G::WORDS);
    const T* const tp = nullptr;  // selects word()'s storage type

    const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * BI + tx;
    const int tyn = ty + 1 < BJ ? ty + 1 : ty, tym = ty > 0 ? ty - 1 : ty;  // halo rows read themselves
    const int wk0 = BOX ? g.wk0 : 0, nwk = (BOX ? g.wk1 : K + 1) - wk0;
    const int nti = ((BOX ? g.wi1 - g.wi0 : I + 1) + TI - 1) / TI;
    const int ntj = ((BOX ? g.wj1 - g.wj0 : J + 1) + TJ - 1) / TJ;
    const int kz = BOX ? g.ok : 0;  // the lowest plane the arrays hold
    const int sj = BOX ? g.ni : I + 1;
    const int sk = sj * (BOX ? g.nj : J + 1);
    const int ck0 = BOX ? g.ck0 : 0;
    const int cell_sk = BOX ? g.cnj * g.cni : J * I;
    const int64_t cells = (int64_t)(BOX ? g.cnk : K) * cell_sk;
    const int ni_patch = i1 - i0;
    // the block's segment: the tk planes [k0, k1) of segment blockIdx.x /
    // tiles of tile blockIdx.x % tiles, tiles in (j, i) order with i fastest,
    // so the blocks of a wave walk neighbouring tiles' planes together and
    // the halo columns they share come from L2
    const int tiles = nti * ntj, tile = (int)(blockIdx.x % tiles);
    const int i = (BOX ? g.wi0 : 0) + (tile % nti) * TI - S + tx;
    const int j = (BOX ? g.wj0 : 0) + (tile / nti) * TJ - S + ty;
    const int k0 = wk0 + (int)(blockIdx.x / tiles) * tk, k1 = min(k0 + tk, wk0 + nwk);
    const int ks = max(k0 - S, 0);
    const int rlast = k1 - 1 + S + SH;

    const bool inbox = i >= 0 && i <= I && j >= 0 && j <= J
                       && (!BOX || (i - g.oi >= 0 && i - g.oi < g.ni && j - g.oj >= 0 && j - g.oj < g.nj));
    const int col = !inbox ? 0 : BOX ? (j - g.oj) * sj + (i - g.oi) : j * sj + i;
    const bool emit = inbox && tx >= S && tx < S + TI && ty >= S && ty < S + TJ
                      && (!BOX || (i < g.wi1 && j < g.wj1));
    const bool c_hx = inbox && j < J;
    const bool c_hy = inbox && i < I;
    const bool c_hz = inbox && j < J && i < I;
    const bool c_ex = inbox && j >= 1 && j < J && i < I;
    const bool c_ey = inbox && j < J && i >= 1 && i < I;
    const bool c_ez = inbox && j >= 1 && j < J && i >= 1 && i < I;
    const bool c_patch = has_patch && inbox && j >= j0 && j < j1 && i >= i0 && i < i1;
    const bool c_sar = MEANS && emit && j < J && i < I;
    const int cell_col = BOX ? (j - g.cj0) * g.cni + (i - g.ci0) : j * I + i;
    // a field-shaped element of plane k, and cell c's element
    auto fofs = [&](int k) { return (int64_t)(k - kz) * sk + col; };
    auto cofs = [&](int c) { return (int64_t)(c - ck0) * cell_sk + cell_col; };
    // their index parity (which half of a bf16 pair holds them)
    const int skp = sk & 1, colp = col & 1, cskp = cell_sk & 1, ccolp = cell_col & 1;
    auto fodd = [&](int k) { return ((k - kz) & skp) ^ colp; };
    auto codd = [&](int c) { return ((c - ck0) & cskp) ^ ccolp; };
    // a cell whose map value or sums this thread owns in this segment
    auto owned = [&](int c) { return c_sar && c >= k0 && c < k1 && c < K; };
    // bf16: the warp's staged rows of the field-shaped arrays and, with the
    // sigma ring word, of sigma (its owned cells); the ring row of warp ty
    constexpr bool STAGED = sizeof(T) == 2;
    StagedRow fr{}, sr{};
    if constexpr (STAGED) {
        fr = staged_row(inbox, col);
        if constexpr (SAR && !ADE && NC > 0) sr = staged_row(c_sar, cell_col);
    }
    const int wrow = ty * BI;
    // the half-words of plane k's element and cell c's in their staged rows
    auto fhalf = [&](int k) { return (((k - kz) & skp) ^ (fr.col & 1)) + fr.rel; };
    auto chalf = [&](int c) { return (((c - ck0) & cskp) ^ (sr.col & 1)) + sr.rel; };

    // the ring: plane q's fields (and P), and its coefficients (with SAR
    // the sigma and map value of cell q - 1) into slot q % NCS
    auto fetch_fields = [&](int q) {
        if constexpr (STAGED) {
            if (fr.n > 0 && q <= K) {
                const int64_t o = (int64_t)(q - kz) * sk + fr.col;
                stage(rf + 0 * NT + wrow, in.ex, o, fr.n, tx); stage(rf + 1 * NT + wrow, in.ey, o, fr.n, tx);
                stage(rf + 2 * NT + wrow, in.ez, o, fr.n, tx); stage(rf + 3 * NT + wrow, in.hx, o, fr.n, tx);
                stage(rf + 4 * NT + wrow, in.hy, o, fr.n, tx); stage(rf + 5 * NT + wrow, in.hz, o, fr.n, tx);
                if constexpr (ADE) {
                    stage(rf + 6 * NT + wrow, ade.pin[0], o, fr.n, tx);
                    stage(rf + 7 * NT + wrow, ade.pin[1], o, fr.n, tx);
                    stage(rf + 8 * NT + wrow, ade.pin[2], o, fr.n, tx);
                }
            }
        } else if (inbox && q <= K) {
            const int64_t o = fofs(q);
            fetch(rf + 0 * NT + tid, in.ex, o); fetch(rf + 1 * NT + tid, in.ey, o);
            fetch(rf + 2 * NT + tid, in.ez, o); fetch(rf + 3 * NT + tid, in.hx, o);
            fetch(rf + 4 * NT + tid, in.hy, o); fetch(rf + 5 * NT + tid, in.hz, o);
            if constexpr (ADE) {
                fetch(rf + 6 * NT + tid, ade.pin[0], o); fetch(rf + 7 * NT + tid, ade.pin[1], o);
                fetch(rf + 8 * NT + tid, ade.pin[2], o);
            }
        }
    };
    auto fetch_coefs = [&](int q) {
        if constexpr (NC > 0 && STAGED) {
            uint32_t* const wr = rc + (q % NCS) * NC * NT + wrow;
            if (fr.n > 0 && q <= K) {
                const int64_t o = (int64_t)(q - kz) * sk + fr.col;
                if constexpr (ADE) {
#pragma unroll
                    for (int a = 0; a < (SAR ? 18 : 15); ++a) stage(wr + a * NT, ade.c[a], o, fr.n, tx);
                } else {
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                        stage(wr + c * NT, mat.ca[c], o, fr.n, tx);
                        stage(wr + (3 + c) * NT, mat.cb[c], o, fr.n, tx);
                        if constexpr (HET) stage(wr + (6 + c) * NT, mat.hf[c], o, fr.n, tx);
                    }
                }
            }
            if constexpr (SAR) {
                const int c = q - 1;
                if constexpr (!ADE) {
                    if (sr.n > 0 && c >= k0 && c < k1 && c < K)
                        stage(wr + G::C_SIG * NT, mat.sigma, (int64_t)(c - ck0) * cell_sk + sr.col, sr.n, tx);
                }
                if (owned(c)) __pipeline_memcpy_async(wr + G::C_ACC * NT + tx, mat.acc + cofs(c), 4);
            }
        } else if constexpr (NC > 0) {
            uint32_t* w = rc + (q % NCS) * NC * NT + tid;
            if (inbox && q <= K) {
                const int64_t o = fofs(q);
                if constexpr (ADE) {
#pragma unroll
                    for (int a = 0; a < (SAR ? 18 : 15); ++a) fetch(w + a * NT, ade.c[a], o);
                } else {
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                        fetch(w + c * NT, mat.ca[c], o);
                        fetch(w + (3 + c) * NT, mat.cb[c], o);
                        if constexpr (HET) fetch(w + (6 + c) * NT, mat.hf[c], o);
                    }
                }
            }
            if constexpr (SAR) {
                if (owned(q - 1)) {
                    const int64_t oc = cofs(q - 1);
                    if constexpr (!ADE) fetch(w + G::C_SIG * NT, mat.sigma, oc);
                    __pipeline_memcpy_async(w + G::C_ACC * NT, mat.acc + oc, 4);
                }
            }
        }
    };

    // e[m], h[m]: level m's newest plane of this column (level S: H only,
    // and with E cell means (SAR, DFT) its E too); acc[m-1]: the map
    // value of the cell that level m adds to at this pipeline step
    constexpr int NE = ((SAR && !ADE) || DFT) ? S + 1 : S;
    float e[NE][3], h[S + 1][3];
    float acc[SAR ? S : 1];
#pragma unroll
    for (int m = 0; m <= S; ++m) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            if (m < NE) e[m][c] = 0.f;
            h[m][c] = 0.f;
        }
    }
#pragma unroll
    for (int m = 0; m < (SAR ? S : 1); ++m) acc[m] = 0.f;
    // ADE: pl[m], level m's P of its newest plane (m < S); with SAR
    // wl[m-1], level m's edge work of its plane before this step's
    float pl[ADE ? S : 1][3], wl[(ADE && SAR) ? S : 1][3];
#pragma unroll
    for (int m = 0; m < (ADE ? S : 1); ++m)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            pl[m][c] = 0.f;
            wl[(ADE && SAR) ? m : 0][c] = 0.f;
        }

    fetch_fields(ks);
    __pipeline_commit();
    int slot_r = ks % (NCS > 0 ? NCS : 1);  // r % NCS
    for (int r = ks; r <= rlast; ++r) {
        // plane r's fields and plane r-1's coefficients have landed (bf16:
        // the staged words of other lanes' copies too, once the warp meets)
        __pipeline_wait_prior(0);
        if constexpr (STAGED) __syncwarp();
        if constexpr (DFT) {
            // fetch the sums of the cell level 1 starts at this step
            const int c1 = r - 2;
            if (!FOLD && owned(c1)) {
                float* slot = sD + (int64_t)(c1 % S) * 6 * dft.nf * NT + tid;
                const int64_t oc1 = cofs(c1);
                for (int f = 0; f < dft.nf; ++f)
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                        const int64_t a = ((int64_t)f * dft.nc + c) * cells + oc1;
                        __pipeline_memcpy_async(slot + (6 * f + 2 * c) * NT, dft.re + a, 4);
                        __pipeline_memcpy_async(slot + (6 * f + 2 * c + 1) * NT, dft.im + a, 4);
                    }
            }
            __pipeline_commit();
        }
        // eo, ho: the inputs of the next level, i.e. the previous level's
        // plane before this pipeline step replaced it
        float eo[3] = {e[0][0], e[0][1], e[0][2]};
        float ho[3] = {h[0][0], h[0][1], h[0][2]};
        float po[3] = {pl[0][0], pl[0][1], pl[0][2]};  // ADE: P of eo's plane
        if (inbox && r <= K) {
            if constexpr (STAGED) {
                const unsigned short* const fw = halves(rf + wrow) + fhalf(r);  // array a at fw[2 a NT]
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    e[0][c] = widen(fw[2 * c * NT]);
                    h[0][c] = widen(fw[2 * (3 + c) * NT]);
                    if constexpr (ADE) pl[0][c] = widen(fw[2 * (6 + c) * NT]);
                }
            } else {
                const int odd = fodd(r);
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    e[0][c] = word(rf[c * NT + tid], odd, tp);
                    h[0][c] = word(rf[(3 + c) * NT + tid], odd, tp);
                    if constexpr (ADE) pl[0][c] = word(rf[(6 + c) * NT + tid], odd, tp);
                }
            }
        } else {
#pragma unroll
            for (int c = 0; c < 3; ++c) { e[0][c] = 0.f; h[0][c] = 0.f; pl[0][c] = 0.f; }
        }
#pragma unroll
        for (int m = 1; m <= S; ++m) {
            const int k = r - m;
            const bool on_patch = c_patch && k == 0;
            int sl = slot_r - m;  // plane k's coefficient slot
            if (sl < 0) sl += NCS;
            const uint32_t* cw = rc + sl * NC * NT + tid;
            const int kodd = fodd(k);
            const unsigned short* cwh = nullptr;  // bf16: plane k's staged rows, coefficient a at cwh[2 a NT]
            if constexpr (STAGED && NC > 0) cwh = halves(rc + sl * NC * NT + wrow) + fhalf(k);
            // coefficient a of plane k: from the ring, or from memory
            auto coef = [&](int a, const T* arr) {
                if constexpr (NC > 0 && STAGED) return widen(cwh[2 * a * NT]);
                else if constexpr (NC > 0) return word(cw[a * NT], kodd, tp);
                else return ld(arr, fofs(k));
            };
            if (m >= 2 && on_patch) {
                // step m's hard-set, in level m's inputs only
                const int d = (m - 2) * ni_patch + (i - i0);
                eo[0] = 0.f;
                eo[2] = ld(ez_rows, d);
                ho[0] = ld(hx_rows, d);
                ho[2] = 0.f;
            }
            // E of level m-1 on plane k, for the +1 neighbour reads: along
            // j through shared memory, along i from the next lane
            sE[0][ty][tx] = eo[0];
            sE[1][ty][tx] = eo[2];
            __syncthreads();
            if (m == 1) {
                // every thread is past step r-1: load plane r+1 and the
                // coefficients of plane r into the slots it has read
                if (r + 1 <= rlast) {
                    fetch_fields(r + 1);
                    fetch_coefs(r);
                }
                __pipeline_commit();
            }
            const float ex_pj = sE[0][tyn][tx];
            const float ez_pj = sE[1][tyn][tx];
            const float ey_pi = __shfl_down_sync(FULL, eo[1], 1);
            const float ez_pi = __shfl_down_sync(FULL, eo[2], 1);

            // H of level m on plane k (Hx, Hy: k < K; Hz: k <= K); a
            // shard's lead-in does not reach below its arrays (kz >= 0)
            const bool kh = k >= kz && k < K;
            const bool khz = k >= kz && k <= K;
            float hn[3] = {ho[0], ho[1], ho[2]};
            if (kh && c_hx && !on_patch)
                hn[0] = leap(ho[0], HET ? coef(6, mat.hf[0]) : fh, e[m - 1][1], eo[1], ez_pj, eo[2]);
            if (kh && c_hy)
                hn[1] = leap(ho[1], HET ? coef(7, mat.hf[1]) : fh, ez_pi, eo[2], e[m - 1][0], eo[0]);
            if (khz && c_hz && !on_patch)
                hn[2] = leap(ho[2], HET ? coef(8, mat.hf[2]) : fh, ex_pj, eo[0], ey_pi, eo[1]);

            sH[0][ty][tx] = hn[0];
            sH[1][ty][tx] = hn[2];
            __syncthreads();
            const float hx_mj = sH[0][tym][tx];
            const float hz_mj = sH[1][tym][tx];
            const float hy_mi = __shfl_up_sync(FULL, hn[1], 1);
            const float hz_mi = __shfl_up_sync(FULL, hn[2], 1);

            // E of level m on plane k (Ex, Ey: 1 <= k < K; Ez: k < K);
            // h[m] still holds level m's H on plane k-1
            const bool ke = k >= 1 && k >= kz && k < K;
            const bool kez = k >= kz && k < K;
            float en[3] = {eo[0], eo[1], eo[2]};
            float pn[3] = {po[0], po[1], po[2]};  // ADE: P of level m on plane k
            float wn[3] = {0.f, 0.f, 0.f};        // ADE + SAR: its edge work
            if constexpr (ADE) {
                const float cv[3] = {curl(hn[2], hz_mj, hn[1], h[m][1]), curl(hn[0], h[m][0], hn[2], hz_mi),
                                     curl(hn[1], hy_mi, hn[0], hx_mj)};
                const bool upd[3] = {ke && c_ex, ke && c_ey, kez && c_ez};
#pragma unroll
                for (int c = 0; c < 3; ++c)
                    if (upd[c])
                        en[c] = ade_update<SAR>(coef(c, ade.c[c]), coef(3 + c, ade.c[3 + c]),
                                                coef(6 + c, ade.c[6 + c]), coef(9 + c, ade.c[9 + c]),
                                                coef(12 + c, ade.c[12 + c]),
                                                SAR ? coef(15 + c, ade.c[15 + c]) : 0.f, eo[c], po[c], cv[c],
                                                mat.dt, pn[c], wn[c]);
            } else if (LOSSY) {
                if (ke && c_ex)
                    en[0] = lossy(eo[0], coef(0, mat.ca[0]), coef(3, mat.cb[0]), hn[2], hz_mj, hn[1], h[m][1]);
                if (ke && c_ey)
                    en[1] = lossy(eo[1], coef(1, mat.ca[1]), coef(4, mat.cb[1]), hn[0], h[m][0], hn[2], hz_mi);
                if (kez && c_ez)
                    en[2] = lossy(eo[2], coef(2, mat.ca[2]), coef(5, mat.cb[2]), hn[1], hy_mi, hn[0], hx_mj);
            } else {
                if (ke && c_ex) en[0] = leap(eo[0], fe, hn[2], hz_mj, hn[1], h[m][1]);
                if (ke && c_ey) en[1] = leap(eo[1], fe, hn[0], h[m][0], hn[2], hz_mi);
                if (kez && c_ez) en[2] = leap(eo[2], fe, hn[1], hy_mi, hn[0], hx_mj);
            }

            // the cell means of cell k-1 at level m: of E^m (Debye SAR:
            // of the edge work) on planes k-1 (lo) and k (up) and their
            // j+1 / i+1 neighbours
            const int cell = k - 1;
            float me[3];  // E cell means (E-mean SAR, DFT)
            if constexpr (SAR) {
                float lo_[3], up_[3];
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    if constexpr (ADE) {
                        lo_[c] = wl[m - 1][c];
                        up_[c] = wn[c];
                    } else {
                        lo_[c] = e[m][c];
                        up_[c] = en[c];
                    }
                }
                sS[0][ty][tx] = lo_[0];
                sS[1][ty][tx] = up_[0];
                sS[2][ty][tx] = lo_[2];
                __syncthreads();
                // emitted columns stop S+1 short of the block's edge, so
                // the j+1 and i+1 reads of an owned cell lie inside it
                const float xl = sS[0][tyn][tx], xu = sS[1][tyn][tx], zj = sS[2][tyn][tx];
                const float yl = __shfl_down_sync(FULL, lo_[1], 1);
                const float yu = __shfl_down_sync(FULL, up_[1], 1);
                const float zi = __shfl_down_sync(FULL, lo_[2], 1);
                const float zji = __shfl_down_sync(FULL, zj, 1);
                const float mex = mean4(lo_[0], up_[0], xl, xu);
                const float mey = mean4(lo_[1], yl, up_[1], yu);
                const float mez = mean4(lo_[2], zj, zi, zji);
                if constexpr (!ADE) {
                    me[0] = mex;
                    me[1] = mey;
                    me[2] = mez;
                }
                if (owned(cell)) {
                    float inc;
                    if constexpr (ADE) {
                        inc = __fmul_rn(__fadd_rn(__fadd_rn(mex, mey), mez), mat.dt);
                    } else {
                        const float sq = __fadd_rn(__fadd_rn(__fmul_rn(mex, mex), __fmul_rn(mey, mey)),
                                                   __fmul_rn(mez, mez));
                        float sig;
                        if constexpr (NC > 0 && STAGED)
                            sig = widen(halves(rc + (sl * NC + G::C_SIG) * NT + wrow)[chalf(cell)]);
                        else sig = NC > 0 ? word(cw[G::C_SIG * NT], codd(cell), tp) : ld(mat.sigma, cofs(cell));
                        inc = __fmul_rn(__fmul_rn(sig, sq), mat.dt);
                    }
                    if (m == 1) acc[0] = NC > 0 ? __uint_as_float(cw[G::C_ACC * NT]) : mat.acc[cofs(cell)];
                    acc[m - 1] = __fadd_rn(acc[m - 1], inc);
                    if (m == S) mat.acc[cofs(cell)] = acc[S - 1];
                }
                if constexpr (ADE) {
#pragma unroll
                    for (int c = 0; c < 3; ++c) wl[m - 1][c] = wn[c];
                }
            }
            if constexpr (DFT) {
                if constexpr (!SAR || ADE) {
                    // the Debye SAR's work means must be read before E
                    // replaces them
                    if constexpr (SAR) __syncthreads();
                    sS[0][ty][tx] = e[m][0];
                    sS[1][ty][tx] = en[0];
                    sS[2][ty][tx] = e[m][2];
                    __syncthreads();
                    const float xl = sS[0][tyn][tx], xu = sS[1][tyn][tx], zj = sS[2][tyn][tx];
                    const float yl = __shfl_down_sync(FULL, e[m][1], 1);
                    const float yu = __shfl_down_sync(FULL, en[1], 1);
                    const float zi = __shfl_down_sync(FULL, e[m][2], 1);
                    const float zji = __shfl_down_sync(FULL, zj, 1);
                    me[0] = mean4(e[m][0], en[0], xl, xu);
                    me[1] = mean4(e[m][1], yl, en[1], yu);
                    me[2] = mean4(e[m][2], zj, zi, zji);
                }
                if (owned(cell)) {
                    const int64_t oc = cofs(cell);
                    if constexpr (FOLD) {
                        // the means mode: level m's means into the buffer
                        float* const mb = dft.mb + (int64_t)(m - 1) * 3 * cells + oc;
                        mb[0] = me[0];
                        mb[cells] = me[1];
                        mb[2 * cells] = me[2];
                    } else {
                        const float* wm = dft.w + (m - 1) * 2 * dft.nf;
                        if (m == 1) __pipeline_wait_prior(1);  // the sums, not the ring's next plane
                        float* slot = sD + (int64_t)(cell % S) * 6 * dft.nf * NT + tid;
                        for (int f = 0; f < dft.nf; ++f) {
                            const float cwt = __ldg(wm + f), swt = __ldg(wm + dft.nf + f);
#pragma unroll
                            for (int c = 0; c < 3; ++c) {
                                float* pr = slot + (6 * f + 2 * c) * NT;
                                const float vr = __fadd_rn(pr[0], __fmul_rn(cwt, me[c]));
                                const float vi = __fsub_rn(pr[NT], __fmul_rn(swt, me[c]));
                                if (m == S) {
                                    const int64_t a = ((int64_t)f * dft.nc + c) * cells + oc;
                                    dft.re[a] = vr;
                                    dft.im[a] = vi;
                                } else {
                                    pr[0] = vr;
                                    pr[NT] = vi;
                                }
                            }
                        }
                    }
                }
            }

            if (m < S) {
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    eo[c] = e[m][c];
                    ho[c] = h[m][c];
                    e[m][c] = en[c];
                    h[m][c] = hn[c];
                    if constexpr (ADE) {
                        po[c] = pl[m][c];
                        pl[m][c] = pn[c];
                    }
                }
            } else {
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    h[m][c] = hn[c];
                    if constexpr (NE > S) e[NE - 1][c] = en[c];
                }
                if (emit && k >= k0 && k < k1) {
                    const int64_t o = fofs(k);
                    st(out.ex, o, en[0]); st(out.ey, o, en[1]); st(out.ez, o, en[2]);
                    st(out.hx, o, hn[0]); st(out.hy, o, hn[1]); st(out.hz, o, hn[2]);
                    if constexpr (ADE) {
                        st(ade.pout[0], o, pn[0]); st(ade.pout[1], o, pn[1]); st(ade.pout[2], o, pn[2]);
                    }
                }
            }
        }
        if constexpr (SAR) {
            // the cell level m added to is level m+1's at the next step
#pragma unroll
            for (int m = S - 1; m >= 1; --m) acc[m] = acc[m - 1];
        }
        if constexpr (NCS > 0) slot_r = slot_r + 1 == NCS ? 0 : slot_r + 1;
    }
}

// the dynamic shared memory of a ring_kernel launch: the ring, and the DFT
// chain (6 * nf sums of S cells a thread)
template <int S, int BJ, bool CR, bool LOSSY, bool HET, bool SAR, bool ADE, bool DFT>
size_t ring_bytes(int nf) {
    using G = RingGeom<S, BJ, CR, LOSSY, HET, SAR, ADE, DFT>;
    return (size_t)G::WORDS * 4 + (DFT ? (size_t)S * 6 * nf * G::NT * sizeof(float) : 0);
}

template <typename T, int S, int BJ, bool CR, bool LOSSY, bool HET, bool SAR, bool ADE, bool DFT, bool BOX,
          bool FOLD>
int launch_ring(void* const* in, void* const* out, int K, int J, int I, const Box& g, float fh, float fe, int tk,
                int has_patch, int j0, int j1, int i0, int i1, const void* ez_rows, const void* hx_rows,
                const Material<T>& mat, const AdeSweep<T>& ade, const DftSweep& dft, cudaStream_t stream) {
    const Fields<T> f_in{(const T*)in[0], (const T*)in[1], (const T*)in[2],
                         (const T*)in[3], (const T*)in[4], (const T*)in[5]};
    const OutFields<T> f_out{(T*)out[0], (T*)out[1], (T*)out[2], (T*)out[3], (T*)out[4], (T*)out[5]};
    const size_t dyn = ring_bytes<S, BJ, CR, LOSSY, HET, SAR, ADE, DFT>(dft.nf);
    auto kernel = ring_kernel<T, S, BJ, CR, LOSSY, HET, SAR, ADE, DFT, BOX, FOLD>;
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return (int)e;
    using G = RingGeom<S, BJ, CR, LOSSY, HET, SAR, ADE, DFT>;
    const unsigned nblk = (unsigned)(((g.wk1 - g.wk0 + tk - 1) / tk) * ((g.wj1 - g.wj0 + G::TJ - 1) / G::TJ)
                                     * ((g.wi1 - g.wi0 + G::TI - 1) / G::TI));
    kernel<<<dim3(nblk), dim3(BI, BJ), dyn, stream>>>(f_in, f_out, K, J, I, fh, fe, tk, has_patch, j0, j1,
                                                                i0, i1, (const T*)ez_rows, (const T*)hx_rows, mat,
                                                                ade, dft, g);
    return (int)cudaGetLastError();
}

// The (s, threads along j, coefficient ring) shapes of
// ring_kernel a variant is built at: ops/stream_plan.py (BLOCK_J,
// BLOCK_J_MATERIAL and COEF_RING_MATERIAL, BLOCK_J_DFT, BLOCK_J_DFT_MATERIAL,
// BLOCK_J_ADE, BLOCK_J_ADE_SAR; the Debye DFT variants take the Debye SAR
// shape).  YEE_STREAM_CANDIDATES adds the shapes python -m
// fdtd_tpu_torch.tune_stream times beside them (a build of its own).
template <typename T, bool LOSSY, bool HET, bool SAR, bool ADE, bool DFT, bool BOX, bool FOLD>
int dispatch_ring(int s, int bj, int cr, void* const* in, void* const* out, int K, int J, int I,
                  const Box& g, float fh, float fe, int tk, int has_patch, int j0, int j1, int i0, int i1, const void* ez_rows,
                  const void* hx_rows, const Material<T>& mat, const AdeSweep<T>& ade, const DftSweep& dft,
                  cudaStream_t stream) {
#define YEE_RING_CASE(S_, BJ_, CR_)                                                                    \
    if (s == S_ && bj == BJ_ && cr == (CR_))                                                              \
        return launch_ring<T, S_, BJ_, CR_, LOSSY, HET, SAR, ADE, DFT, BOX, FOLD>(in, out, K, J, I, g, fh, fe, tk, \
                                                                           has_patch, j0, j1, i0, i1,      \
                                                                           ez_rows, hx_rows, mat, ade, dft, \
                                                                           stream);
    if constexpr (ADE) {
#ifdef YEE_STREAM_CANDIDATES
        YEE_RING_CASE(2, 32, false)
        if constexpr (SAR || DFT) {
            YEE_RING_CASE(2, 24, true)
        } else {
            YEE_RING_CASE(2, 16, true)
        }
        if constexpr (!SAR) {
            YEE_RING_CASE(4, 24, false)
        }
#endif
        if constexpr (SAR || DFT) {
            YEE_RING_CASE(2, 16, true)
        } else {
            YEE_RING_CASE(2, 24, true)
        }
    } else if constexpr (DFT) {
#ifdef YEE_STREAM_CANDIDATES
        YEE_RING_CASE(2, 32, false)
        if constexpr (LOSSY) {
            YEE_RING_CASE(4, 24, false)
        } else {
            YEE_RING_CASE(2, 24, false)
        }
#endif
        if constexpr (LOSSY) {
            YEE_RING_CASE(2, 24, true)
        } else {
            YEE_RING_CASE(4, 24, false)
        }
        if constexpr (BOX && !HET && !SAR) {
            // the interior of a CPML sweep with the bands (BLOCK_J_PML_INTERIOR_DFT)
            YEE_RING_CASE(2, 24, false)
        }
    } else if constexpr (!LOSSY) {
#ifdef YEE_STREAM_CANDIDATES
        YEE_RING_CASE(4, 24, false)
#endif
        YEE_RING_CASE(8, 24, false)
        YEE_RING_CASE(4, 32, false)
        YEE_RING_CASE(2, 32, false)
    } else {
#ifdef YEE_STREAM_CANDIDATES
        YEE_RING_CASE(4, 32, true)
        YEE_RING_CASE(2, 24, true)
#endif
        YEE_RING_CASE(8, 24, false)
        YEE_RING_CASE(4, 24, true)
        YEE_RING_CASE(2, 32, true)
    }
#undef YEE_RING_CASE
    return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The CPML sweep's shell (pml_kernel: K11; see "The CPML sweep on the
// Hopper core" above)
// ---------------------------------------------------------------------------

// The shape of a pml_kernel instantiation: tiles, and the ring's words a
// thread: the six fields of the next plane, level 0's twelve psi of the
// plane level 1 reads next, and with CR the lossy ca/cb of the last S + 1
// planes
template <int S, int BJ, bool CR, bool LOSSY, bool DFT>
struct PmlGeom {
    static constexpr int SH = DFT ? 1 : 0;
    static constexpr int TJ = BJ - 2 * S - SH;
    static constexpr int TI = BI - 2 * S - SH;
    static constexpr int NT = BI * BJ;
    static constexpr int NC = CR && LOSSY ? 6 : 0;
    static constexpr int NCS = NC > 0 ? S + 1 : 0;
    static constexpr int WORDS = (6 + 12 + NCS * NC) * NT;
};

// A block's entry of the block list, two int4: (k0, k1, j0, j1) and (i0,
// i1, 0, 0): it advances the planes [k0, k1) of the emitted columns
// [j0, j1) x [i0, i1) (at most TJ x TI; ops/stream_plan.py::pml_blocks).
template <typename T, int S, int BJ, bool CR, bool LOSSY, bool DFT, bool FOLD = false>
__global__ void __launch_bounds__(BI * BJ, 1)
pml_kernel(Fields<T> in, OutFields<T> out, int K, int J, int I, float fh, float fe, const int4* __restrict__ blocks,
           int has_patch, int j0, int j1, int i0, int i1, const T* __restrict__ ez_rows,
           const T* __restrict__ hx_rows, Material<T> mat, PsiSweep<T> psw, DftSweep dft) {
    using G = PmlGeom<S, BJ, CR, LOSSY, DFT>;
    constexpr int SH = G::SH, NT = G::NT, NC = G::NC, NCS = G::NCS;
    static_assert(G::TJ >= 1 && G::TI >= 1, "the block is too small for S steps");
    static_assert(S >= 2, "the psi chain keeps levels 1..S-1");
    __shared__ float sE[2][BJ][BI];  // level m-1's Ex, Ez on plane k: the j+1 reads
    __shared__ float sH[2][BJ][BI];  // level m's Hx, Hz on plane k: the j-1 reads
    __shared__ float sS[DFT ? 3 : 1][DFT ? BJ : 1][BI];  // DFT: the j+1 reads of the cell means
    extern __shared__ uint32_t ring[];
    uint32_t* const rf = ring;            // [6][NT]: the next plane's fields
    uint32_t* const rp = ring + 6 * NT;   // [12][NT]: level 0's psi of the plane level 1 reads next
    uint32_t* const rc = ring + 18 * NT;  // [NCS][NC][NT]: ca/cb of planes k % NCS
    const int n = psw.n, w = 2 * n;
    // the (b, c) tables of the twelve terms in fp32, one pair a term and
    // slab row: (b, c) of term t at row q at tab[tw + q]
    float2* const tab = reinterpret_cast<float2*>(ring + G::WORDS);
    // DFT: the sums of the S cells in flight, slot (cell % S) of this thread:
    // sD[(slot * 6 * nf + q) * NT + tid], q = 6f + 2c + (0: re, 1: im)
    float* const sD = reinterpret_cast<float*>(tab + 12 * w);
    const T* const tp = nullptr;  // selects word()'s storage type

    const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * BI + tx;
    const int tyn = ty + 1 < BJ ? ty + 1 : ty, tym = ty > 0 ? ty - 1 : ty;  // halo rows read themselves
    const int4 ba = __ldg(blocks + 2 * blockIdx.x), bb = __ldg(blocks + 2 * blockIdx.x + 1);
    const int k0 = ba.x, k1 = ba.y;
    const int i = bb.x - S + tx, j = ba.z - S + ty;
    const int ks = max(k0 - S, 0);
    const int rlast = k1 - 1 + S + SH;
    const int sj = I + 1, sk = sj * (J + 1);
    const int cell_sk = J * I;
    const int64_t cells = (int64_t)K * cell_sk;
    const int ni_patch = i1 - i0;

    const bool inbox = i >= 0 && i <= I && j >= 0 && j <= J;
    const int col = !inbox ? 0 : j * sj + i;
    const bool emit = inbox && j >= ba.z && j < ba.w && i >= bb.x && i < bb.y;
    const bool c_hx = inbox && j < J;
    const bool c_hy = inbox && i < I;
    const bool c_hz = inbox && j < J && i < I;
    const bool c_ex = inbox && j >= 1 && j < J && i < I;
    const bool c_ey = inbox && j < J && i >= 1 && i < I;
    const bool c_ez = inbox && j >= 1 && j < J && i >= 1 && i < I;
    const bool c_patch = has_patch && inbox && j >= j0 && j < j1 && i >= i0 && i < i1;
    const bool c_sar = DFT && emit && j < J && i < I;
    const int cell_col = j * I + i;
    auto fofs = [&](int k) { return (int64_t)k * sk + col; };
    auto cofs = [&](int c) { return (int64_t)c * cell_sk + cell_col; };
    const int skp = sk & 1, colp = col & 1;
    auto fodd = [&](int k) { return (k & skp) ^ colp; };
    auto owned = [&](int c) { return c_sar && c >= k0 && c < k1 && c < K; };

    // the terms this column can hold psi of (bit t)
    unsigned cols = 0;
    if (inbox) {
#pragma unroll
        for (int t = 0; t < 12; ++t)
            if (psi_column(t, j, i, K, J, I, n)) cols |= 1u << t;
    }
    // the terms that hold psi at plane k of this column (bit t): the
    // column's bits of the terms whose region's k range (and, for a k-axis
    // term, its slabs) admits k, worked out once a plane and level
    auto holding = [&](int k) {
        unsigned m = 0;
#pragma unroll
        for (int t = 0; t < 12; ++t) {
            const TermRegion g = term_region(t, K, J, I);
            if (k >= g.k0 && k < g.k0 + g.Lk && (g.axis != 0 || slab_row(k - g.k0, g.Lk, n) >= 0)) m |= 1u << t;
        }
        return cols & m;
    };
    for (int q = tid; q < 12 * w; q += NT) {
        // the pass's (6, 2, 2n) table: b of its term tt at (2tt)w + row, c at (2tt + 1)w + row
        const T* tb = psw.tab[q / (6 * w)];
        const int tt = q / w % 6, row = q % w;
        tab[q] = make_float2(ld(tb, (2 * tt) * w + row), ld(tb, (2 * tt + 1) * w + row));
    }
    __syncthreads();

    // the ring: plane q's fields, level 0's psi of plane q, and with CR the
    // ca/cb of plane q into slot q % NCS.  podd: the parity of each psi
    // element fetched (which half of a bf16 pair holds it); hnext: the terms
    // held at the plane fetched (holding(q))
    unsigned podd = 0, hnext = 0;
    auto fetch_fields = [&](int q) {
        if (inbox && q <= K) {
            const int64_t o = fofs(q);
            fetch(rf + 0 * NT + tid, in.ex, o); fetch(rf + 1 * NT + tid, in.ey, o);
            fetch(rf + 2 * NT + tid, in.ez, o); fetch(rf + 3 * NT + tid, in.hx, o);
            fetch(rf + 4 * NT + tid, in.hy, o); fetch(rf + 5 * NT + tid, in.hz, o);
        }
    };
    auto fetch_psi = [&](int q) {
        podd = 0;
        hnext = cols != 0 ? holding(q) : 0u;
#pragma unroll
        for (int t = 0; t < 12; ++t)
            if ((hnext >> t) & 1u) {
                const int o = psi_offset(t, q, j, i, K, J, I, n, psi_row(t, q, j, i, K, J, I, n));
                fetch(rp + t * NT + tid, psw.in[t], (int64_t)o);
                podd |= (unsigned)(o & 1) << t;
            }
    };
    auto fetch_coefs = [&](int q) {
        if constexpr (NC > 0) {
            uint32_t* cw = rc + (q % NCS) * NC * NT + tid;
            if (inbox && q <= K) {
                const int64_t o = fofs(q);
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    fetch(cw + c * NT, mat.ca[c], o);
                    fetch(cw + (3 + c) * NT, mat.cb[c], o);
                }
            }
        }
    };

    // e[m], h[m]: level m's newest plane of this column (level S: H only,
    // and with the DFT cell means its E too); ps[m-1]: the twelve psi of
    // level m's newest plane (1 <= m < S); hl[m-1]: the terms held at the
    // plane level m updates at this step (level m-1's at the step before)
    constexpr int NE = DFT ? S + 1 : S;
    float e[NE][3], h[S + 1][3];
    float ps[S - 1][12];
    unsigned hl[S];
#pragma unroll
    for (int m = 0; m < S; ++m) hl[m] = 0u;
#pragma unroll
    for (int m = 0; m <= S; ++m) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            if (m < NE) e[m][c] = 0.f;
            h[m][c] = 0.f;
        }
    }
#pragma unroll
    for (int m = 0; m < S - 1; ++m)
#pragma unroll
        for (int t = 0; t < 12; ++t) ps[m][t] = 0.f;

    fetch_fields(ks);
    fetch_psi(ks - 1);
    __pipeline_commit();
    int slot_r = ks % (NCS > 0 ? NCS : 1);  // r % NCS
    for (int r = ks; r <= rlast; ++r) {
        // plane r's fields, plane r-1's psi and coefficients have landed
        __pipeline_wait_prior(0);
        if constexpr (DFT) {
            // fetch the sums of the cell level 1 starts at this step
            const int c1 = r - 2;
            if (!FOLD && owned(c1)) {
                float* slot = sD + (int64_t)(c1 % S) * 6 * dft.nf * NT + tid;
                const int64_t oc1 = cofs(c1);
                for (int f = 0; f < dft.nf; ++f)
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                        const int64_t a = ((int64_t)f * dft.nc + c) * cells + oc1;
                        __pipeline_memcpy_async(slot + (6 * f + 2 * c) * NT, dft.re + a, 4);
                        __pipeline_memcpy_async(slot + (6 * f + 2 * c + 1) * NT, dft.im + a, 4);
                    }
            }
            __pipeline_commit();
        }
        // eo, ho: the inputs of the next level, i.e. the previous level's
        // plane before this pipeline step replaced it; pso: their psi
        // (level 1: level 0's of plane r-1, from the ring)
        float eo[3] = {e[0][0], e[0][1], e[0][2]};
        float ho[3] = {h[0][0], h[0][1], h[0][2]};
#pragma unroll
        for (int m = S - 1; m >= 1; --m) hl[m] = hl[m - 1];
        hl[0] = hnext;
        float pso[12];
#pragma unroll
        for (int t = 0; t < 12; ++t)
            pso[t] = ((hl[0] >> t) & 1u) ? word(rp[t * NT + tid], (podd >> t) & 1u, tp) : 0.f;
        if (inbox && r <= K) {
            const int odd = fodd(r);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                e[0][c] = word(rf[c * NT + tid], odd, tp);
                h[0][c] = word(rf[(3 + c) * NT + tid], odd, tp);
            }
        } else {
#pragma unroll
            for (int c = 0; c < 3; ++c) { e[0][c] = 0.f; h[0][c] = 0.f; }
        }
#pragma unroll
        for (int m = 1; m <= S; ++m) {
            const int k = r - m;
            const bool on_patch = c_patch && k == 0;
            int sl = slot_r - m;  // plane k's coefficient slot
            if (sl < 0) sl += NCS;
            const uint32_t* cw = rc + sl * NC * NT + tid;
            const int kodd = fodd(k);
            // coefficient a of plane k: from the ring, or from memory
            auto coef = [&](int a, const T* arr) {
                if constexpr (NC > 0) return word(cw[a * NT], kodd, tp);
                else return ld(arr, fofs(k));
            };
            if (m >= 2 && on_patch) {
                // step m's hard-set, in level m's inputs only
                const int d = (m - 2) * ni_patch + (i - i0);
                eo[0] = 0.f;
                eo[2] = ld(ez_rows, d);
                ho[0] = ld(hx_rows, d);
                ho[2] = 0.f;
            }
            // E of level m-1 on plane k, for the +1 neighbour reads: along
            // j through shared memory, along i from the next lane
            sE[0][ty][tx] = eo[0];
            sE[1][ty][tx] = eo[2];
            __syncthreads();
            if (m == 1) {
                // every thread is past step r-1 and has read plane r-1's
                // psi: load plane r+1's fields, plane r's psi and
                // coefficients into the slots it has read
                if (r + 1 <= rlast) {
                    fetch_fields(r + 1);
                    fetch_psi(r);
                    fetch_coefs(r);
                }
                __pipeline_commit();
            }
            const float ex_pj = sE[0][tyn][tx];
            const float ez_pj = sE[1][tyn][tx];
            const float ey_pi = __shfl_down_sync(FULL, eo[1], 1);
            const float ez_pi = __shfl_down_sync(FULL, eo[2], 1);

            // term t's psi at this cell, where it holds one: psn <- b*pso +
            // c*d, and the field v <- v +- f*psn when `add`; returns v
            const unsigned held = hl[m - 1];
            float psn[12];
#pragma unroll
            for (int t = 0; t < 12; ++t) psn[t] = pso[t];
            auto term = [&](int t, int sign, float v, float f, float d, bool add) {
                if (!((held >> t) & 1u)) return v;
                const float2 bc = tab[t * w + psi_row(t, k, j, i, K, J, I, n)];
                psn[t] = __fadd_rn(__fmul_rn(bc.x, pso[t]), __fmul_rn(bc.y, d));
                if (!add) return v;
                const float corr = __fmul_rn(f, psn[t]);
                return sign > 0 ? __fadd_rn(v, corr) : __fsub_rn(v, corr);
            };

            // H of level m on plane k (Hx, Hy: k < K; Hz: k <= K); the
            // curl's differences feed the H psi terms, whose adds the
            // source patch skips while their recursions run
            const bool kh = k >= 0 && k < K;
            const bool khz = k >= 0 && k <= K;
            float hn[3] = {ho[0], ho[1], ho[2]};
            if (kh && c_hx) {  // hx_y (-, dEz along j), hx_z (+, dEy along k)
                const float dk = __fsub_rn(e[m - 1][1], eo[1]), dj = __fsub_rn(ez_pj, eo[2]);
                float v = __fadd_rn(ho[0], __fmul_rn(fh, __fsub_rn(dk, dj)));
                v = term(0, -1, v, fh, dj, !on_patch);
                v = term(1, +1, v, fh, dk, !on_patch);
                if (!on_patch) hn[0] = v;
            }
            if (kh && c_hy) {  // hy_x (+, dEz along i), hy_z (-, dEx along k)
                const float di = __fsub_rn(ez_pi, eo[2]), dk = __fsub_rn(e[m - 1][0], eo[0]);
                const float v = term(2, +1, __fadd_rn(ho[1], __fmul_rn(fh, __fsub_rn(di, dk))), fh, di, true);
                hn[1] = term(3, -1, v, fh, dk, true);
            }
            if (khz && c_hz) {  // hz_y (+, dEx along j), hz_x (-, dEy along i)
                const float dj = __fsub_rn(ex_pj, eo[0]), di = __fsub_rn(ey_pi, eo[1]);
                float v = __fadd_rn(ho[2], __fmul_rn(fh, __fsub_rn(dj, di)));
                v = term(4, +1, v, fh, dj, !on_patch);
                v = term(5, -1, v, fh, di, !on_patch);
                if (!on_patch) hn[2] = v;
            }

            sH[0][ty][tx] = hn[0];
            sH[1][ty][tx] = hn[2];
            __syncthreads();
            const float hx_mj = sH[0][tym][tx];
            const float hz_mj = sH[1][tym][tx];
            const float hy_mi = __shfl_up_sync(FULL, hn[1], 1);
            const float hz_mi = __shfl_up_sync(FULL, hn[2], 1);

            // E of level m on plane k (Ex, Ey: 1 <= k < K; Ez: k < K), then
            // its psi terms with the factor of the update (fe or cb); h[m]
            // still holds level m's H on plane k-1
            const bool ke = k >= 1 && k < K;
            const bool kez = k >= 0 && k < K;
            float en[3] = {eo[0], eo[1], eo[2]};
            if (ke && c_ex) {  // ex_y (+, dHz along j), ex_z (-, dHy along k)
                const float f = LOSSY ? coef(3, mat.cb[0]) : fe;
                const float v = LOSSY ? lossy(eo[0], coef(0, mat.ca[0]), f, hn[2], hz_mj, hn[1], h[m][1])
                                      : leap(eo[0], fe, hn[2], hz_mj, hn[1], h[m][1]);
                en[0] = term(7, -1, term(6, +1, v, f, __fsub_rn(hn[2], hz_mj), true), f,
                             __fsub_rn(hn[1], h[m][1]), true);
            }
            if (ke && c_ey) {  // ey_x (-, dHz along i), ey_z (+, dHx along k)
                const float f = LOSSY ? coef(4, mat.cb[1]) : fe;
                const float v = LOSSY ? lossy(eo[1], coef(1, mat.ca[1]), f, hn[0], h[m][0], hn[2], hz_mi)
                                      : leap(eo[1], fe, hn[0], h[m][0], hn[2], hz_mi);
                en[1] = term(9, +1, term(8, -1, v, f, __fsub_rn(hn[2], hz_mi), true), f,
                             __fsub_rn(hn[0], h[m][0]), true);
            }
            if (kez && c_ez) {  // ez_x (+, dHy along i), ez_y (-, dHx along j)
                const float f = LOSSY ? coef(5, mat.cb[2]) : fe;
                const float v = LOSSY ? lossy(eo[2], coef(2, mat.ca[2]), f, hn[1], hy_mi, hn[0], hx_mj)
                                      : leap(eo[2], fe, hn[1], hy_mi, hn[0], hx_mj);
                en[2] = term(11, -1, term(10, +1, v, f, __fsub_rn(hn[1], hy_mi), true), f,
                             __fsub_rn(hn[0], hx_mj), true);
            }

            if constexpr (DFT) {
                // the E cell means of cell k-1 at level m: E on planes k-1
                // (e[m]) and k (en) and their j+1 / i+1 neighbours
                sS[0][ty][tx] = e[m][0];
                sS[1][ty][tx] = en[0];
                sS[2][ty][tx] = e[m][2];
                __syncthreads();
                const float xl = sS[0][tyn][tx], xu = sS[1][tyn][tx], zj = sS[2][tyn][tx];
                const float yl = __shfl_down_sync(FULL, e[m][1], 1);
                const float yu = __shfl_down_sync(FULL, en[1], 1);
                const float zi = __shfl_down_sync(FULL, e[m][2], 1);
                const float zji = __shfl_down_sync(FULL, zj, 1);
                const float me[3] = {mean4(e[m][0], en[0], xl, xu), mean4(e[m][1], yl, en[1], yu),
                                     mean4(e[m][2], zj, zi, zji)};
                const int cell = k - 1;
                if (owned(cell)) {
                    const int64_t oc = cofs(cell);
                    if constexpr (FOLD) {
                        // the means mode: level m's means into the buffer
                        float* const mb = dft.mb + (int64_t)(m - 1) * 3 * cells + oc;
                        mb[0] = me[0];
                        mb[cells] = me[1];
                        mb[2 * cells] = me[2];
                    } else {
                        const float* wm = dft.w + (m - 1) * 2 * dft.nf;
                        if (m == 1) __pipeline_wait_prior(1);  // the sums, not the ring's next plane
                        float* slot = sD + (int64_t)(cell % S) * 6 * dft.nf * NT + tid;
                        for (int f = 0; f < dft.nf; ++f) {
                            const float cwt = __ldg(wm + f), swt = __ldg(wm + dft.nf + f);
#pragma unroll
                            for (int c = 0; c < 3; ++c) {
                                float* pr = slot + (6 * f + 2 * c) * NT;
                                const float vr = __fadd_rn(pr[0], __fmul_rn(cwt, me[c]));
                                const float vi = __fsub_rn(pr[NT], __fmul_rn(swt, me[c]));
                                if (m == S) {
                                    const int64_t a = ((int64_t)f * dft.nc + c) * cells + oc;
                                    dft.re[a] = vr;
                                    dft.im[a] = vi;
                                } else {
                                    pr[0] = vr;
                                    pr[NT] = vi;
                                }
                            }
                        }
                    }
                }
            }

            if (m < S) {
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    eo[c] = e[m][c];
                    ho[c] = h[m][c];
                    e[m][c] = en[c];
                    h[m][c] = hn[c];
                }
#pragma unroll
                for (int t = 0; t < 12; ++t) {
                    pso[t] = ps[m - 1][t];
                    ps[m - 1][t] = psn[t];
                }
            } else {
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    h[m][c] = hn[c];
                    if constexpr (NE > S) e[NE - 1][c] = en[c];
                }
                if (emit && k >= k0 && k < k1) {
                    const int64_t o = fofs(k);
                    st(out.ex, o, en[0]); st(out.ey, o, en[1]); st(out.ez, o, en[2]);
                    st(out.hx, o, hn[0]); st(out.hy, o, hn[1]); st(out.hz, o, hn[2]);
#pragma unroll
                    for (int t = 0; t < 12; ++t)
                        if ((held >> t) & 1u)
                            st(psw.out[t], (int64_t)psi_offset(t, k, j, i, K, J, I, n, psi_row(t, k, j, i, K, J, I, n)),
                               psn[t]);
                }
            }
        }
        if constexpr (NCS > 0) slot_r = slot_r + 1 == NCS ? 0 : slot_r + 1;
    }
}

// the dynamic shared memory of a pml_kernel launch: the ring, the (b, c)
// tables and the DFT chain (6 * nf sums of S cells a thread)
template <int S, int BJ, bool CR, bool LOSSY, bool DFT>
size_t pml_bytes(int n, int nf) {
    using G = PmlGeom<S, BJ, CR, LOSSY, DFT>;
    return (size_t)G::WORDS * 4 + (size_t)24 * 2 * n * 4 + (DFT ? (size_t)S * 6 * nf * G::NT * sizeof(float) : 0);
}

template <typename T, int S, int BJ, bool CR, bool LOSSY, bool DFT, bool FOLD>
int launch_pml(void* const* in, void* const* out, int K, int J, int I, float fh, float fe, const int4* blocks,
               int nblocks, int has_patch, int j0, int j1, int i0, int i1, const void* ez_rows, const void* hx_rows,
               const Material<T>& mat, const PsiSweep<T>& psw, const DftSweep& dft, cudaStream_t stream) {
    const Fields<T> f_in{(const T*)in[0], (const T*)in[1], (const T*)in[2],
                         (const T*)in[3], (const T*)in[4], (const T*)in[5]};
    const OutFields<T> f_out{(T*)out[0], (T*)out[1], (T*)out[2], (T*)out[3], (T*)out[4], (T*)out[5]};
    const size_t dyn = pml_bytes<S, BJ, CR, LOSSY, DFT>(psw.n, dft.nf);
    auto kernel = pml_kernel<T, S, BJ, CR, LOSSY, DFT, FOLD>;
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3((unsigned)nblocks), dim3(BI, BJ), dyn, stream>>>(f_in, f_out, K, J, I, fh, fe, blocks, has_patch,
                                                                    j0, j1, i0, i1, (const T*)ez_rows,
                                                                    (const T*)hx_rows, mat, psw, dft);
    return (int)cudaGetLastError();
}

// The (s, threads along j, coefficient ring) shapes of pml_kernel a CPML
// variant is built at: ops/stream_plan.py (BLOCK_J_PML, BLOCK_J_PML_DFT,
// COEF_RING_PML).  YEE_STREAM_CANDIDATES adds the shapes python -m
// fdtd_tpu_torch.tune_stream times beside them.
template <typename T, bool LOSSY, bool DFT, bool FOLD>
int dispatch_pml(int s, int bj, int cr, void* const* in, void* const* out, int K, int J, int I, float fh, float fe,
                 const int4* blocks, int nblocks, int has_patch, int j0, int j1, int i0, int i1, const void* ez_rows,
                 const void* hx_rows, const Material<T>& mat, const PsiSweep<T>& psw, const DftSweep& dft,
                 cudaStream_t stream) {
#define YEE_PML_CASE(S_, BJ_, CR_)                                                                            \
    if (s == S_ && bj == BJ_ && cr == (CR_))                                                                   \
        return launch_pml<T, S_, BJ_, CR_, LOSSY, DFT, FOLD>(in, out, K, J, I, fh, fe, blocks, nblocks, has_patch, j0, \
                                                       j1, i0, i1, ez_rows, hx_rows, mat, psw, dft, stream);
    if constexpr (DFT) {
#ifdef YEE_STREAM_CANDIDATES
        YEE_PML_CASE(2, 16, false)
#endif
        // the lossy means mode carries the ca/cb ring, which the bands'
        // shared memory cannot hold
        YEE_PML_CASE(2, 20, LOSSY && FOLD)
    } else if constexpr (LOSSY) {
#ifdef YEE_STREAM_CANDIDATES
        YEE_PML_CASE(2, 32, true)
        YEE_PML_CASE(2, 20, true)
        YEE_PML_CASE(2, 24, false)
#endif
        YEE_PML_CASE(2, 24, true)
    } else {
#ifdef YEE_STREAM_CANDIDATES
        YEE_PML_CASE(2, 32, false)
        YEE_PML_CASE(2, 20, false)
        YEE_PML_CASE(2, 16, false)
#endif
        YEE_PML_CASE(2, 24, false)
    }
#undef YEE_PML_CASE
    return (int)cudaErrorInvalidValue;
}

// the variant of `code` (bits: 1 lossy, 2 het, 4 SAR, 16 Debye) on
// ring_kernel: the seven non-CPML variants of ops/stream_plan.py::VARIANTS,
// with or without the DFT bands; with BOX (a shard, or the interior of a
// CPML sweep) the five of ops/stream_plan.py::SHARD_VARIANTS, with or
// without the bands.
template <typename T, bool DFT, bool BOX, bool FOLD>
int dispatch_variant(int code, int s, int bj, int cr, void* const* in, void* const* out, int K, int J,
                     int I, const Box& g, float fh, float fe, int tk, int has_patch, int j0, int j1, int i0,
                     int i1, const void* ez_rows, const void* hx_rows, const Material<T>& mat,
                     const AdeSweep<T>& ade, const DftSweep& dft, cudaStream_t stream) {
#define YEE_RING_VARIANT(CODE_, LOSSY_, HET_, SAR_, ADE_)                                                       \
    case CODE_:                                                                                              \
        return dispatch_ring<T, LOSSY_, HET_, SAR_, ADE_, DFT, BOX, FOLD>(s, bj, cr, in, out, K, J, I, g, fh, fe, tk, \
                                                                  has_patch, j0, j1, i0, i1, ez_rows, hx_rows, \
                                                                  mat, ade, dft, stream);
    switch (code) {
        YEE_RING_VARIANT(0, false, false, false, false)   // vacuum
        YEE_RING_VARIANT(1, true, false, false, false)    // lossy
        YEE_RING_VARIANT(5, true, false, true, false)     // lossy + SAR
        YEE_RING_VARIANT(3, true, true, false, false)     // lossy + het
        YEE_RING_VARIANT(7, true, true, true, false)      // lossy + het + SAR
        default: break;
    }
    if constexpr (!BOX) {
        switch (code) {
            YEE_RING_VARIANT(16, false, false, false, true)            // Debye
            YEE_RING_VARIANT(20, false, false, true, true)             // Debye + SAR
            default: break;
        }
    }
    return (int)cudaErrorInvalidValue;
#undef YEE_RING_VARIANT
}

template <typename T>
int sweep(int code, int s, int bj, int cr, void* const* in, void* const* out, int K, int J, int I,
          bool boxed, const Box& g, float fh, float fe, int tk, int has_patch, int j0, int j1, int i0, int i1,
          const void* ez_rows, const void* hx_rows, void* const* coefs, void* const* hf, const void* sigma, void* acc,
          float dt, void* const* psi_in, void* const* psi_out, const void* tab_h, const void* tab_e, int n,
          const void* blocks, int nblocks, void* const* pol_in, void* const* pol_out, const DftSweep& dft,
          cudaStream_t stream) {
    const bool lossy = code & 1, pml = code & 8, ade = code & 16;
#ifdef YEE_STREAM_FOLD
    if (dft.mb == nullptr) return (int)cudaErrorInvalidValue;  // the default build holds every other instantiation
#else
    if (dft.mb != nullptr) return (int)cudaErrorInvalidValue;  // the YEE_STREAM_FOLD build holds the means mode
    const bool bands = dft.re != nullptr;
#endif
    Material<T> mat{};
    AdeSweep<T> ad{};
    for (int q = 0; q < 3; ++q) {
        if (lossy) {
            mat.ca[q] = (const T*)coefs[q];
            mat.cb[q] = (const T*)coefs[3 + q];
        }
        if (hf != nullptr) mat.hf[q] = (const T*)hf[q];
        if (ade) {
            ad.pin[q] = (const T*)pol_in[q];
            ad.pout[q] = (T*)pol_out[q];
        }
    }
    if (ade)
        for (int q = 0; q < (acc != nullptr ? 18 : 15); ++q) ad.c[q] = (const T*)coefs[q];
    mat.sigma = (const T*)sigma;
    mat.acc = (float*)acc;
    mat.dt = dt;
    const float fe_ = (lossy || ade) ? 0.f : fe;
    if (pml) {
        PsiSweep<T> psw{};
        for (int t = 0; t < 12; ++t) {
            psw.in[t] = (const T*)psi_in[t];
            psw.out[t] = (T*)psi_out[t];
        }
        psw.tab[0] = (const T*)tab_h;
        psw.tab[1] = (const T*)tab_e;
        psw.n = n;
        const int4* b = (const int4*)blocks;
#define YEE_PML_SWEEP(LOSSY_, DFT_, FOLD_)                                                                  \
    return dispatch_pml<T, LOSSY_, DFT_, FOLD_>(s, bj, cr, in, out, K, J, I, fh, fe_, b, nblocks, has_patch,  \
                                                 j0, j1, i0, i1, ez_rows, hx_rows, mat, psw, dft, stream);
#ifdef YEE_STREAM_FOLD
        if (lossy) YEE_PML_SWEEP(true, true, true)
        YEE_PML_SWEEP(false, true, true)
#else
        if (lossy && bands) YEE_PML_SWEEP(true, true, false)
        if (lossy) YEE_PML_SWEEP(true, false, false)
        if (bands) YEE_PML_SWEEP(false, true, false)
        YEE_PML_SWEEP(false, false, false)
#endif
#undef YEE_PML_SWEEP
    }
#define YEE_STREAM_SWEEP(DFT_, BOX_, FOLD_)                                                                  \
    return dispatch_variant<T, DFT_, BOX_, FOLD_>(code, s, bj, cr, in, out, K, J, I, g, fh, fe_, tk,         \
                                                  has_patch, j0, j1, i0, i1, ez_rows, hx_rows, mat, ad, dft,  \
                                                  stream);
#ifdef YEE_STREAM_FOLD
    if (boxed) YEE_STREAM_SWEEP(true, true, true)
    YEE_STREAM_SWEEP(true, false, true)
#else
    if (boxed && bands) YEE_STREAM_SWEEP(true, true, false)
    if (boxed) YEE_STREAM_SWEEP(false, true, false)
    if (bands) YEE_STREAM_SWEEP(true, false, false)
    YEE_STREAM_SWEEP(false, false, false)
#endif
#undef YEE_STREAM_SWEEP
}

// geom: null (the whole grid) or 12 ints: the arrays' extents (nk, nj,
// ni), the global index of their origin (ok, oj, oi) and the window to
// emit (wk0, wk1, wj0, wj1, wi0, wi1), global; the cell box is the
// window's cells unless `cells` gives it (ck0, cj0, ci0, cnk, cnj, cni: the
// interior launch of a CPML sweep emits a window of the whole grid's
// arrays, its SAR map and DFT sums).  The arrays must hold s planes before
// the window and s after it (s + 1 with the cell means of SAR and DFT), as
// far as the grid reaches.
bool box_of(const int* geom, const int* cells, int K, int J, int I, int s, bool means, Box* g) {
    if (geom == nullptr) {
        *g = Box{J + 1, I + 1, 0, 0, 0, 0, K + 1, 0, J + 1, 0, I + 1, 0, 0, 0, K, J, I};
        return cells == nullptr;
    }
    const int n[3] = {K + 1, J + 1, I + 1};
    for (int a = 0; a < 3; ++a) {
        const int ext = geom[a], org = geom[3 + a], lo = geom[6 + 2 * a], hi = geom[7 + 2 * a];
        if (ext < 1 || lo < 0 || hi > n[a] || lo >= hi) return false;
        if (org > std::max(lo - s, 0) || org + ext < std::min(hi + s + (means ? 1 : 0), n[a])) return false;
    }
    *g = Box{geom[1], geom[2], geom[3], geom[4], geom[5], geom[6], geom[7], geom[8], geom[9], geom[10], geom[11],
             geom[6], geom[8], geom[10], std::min(geom[7], K) - geom[6], std::min(geom[9], J) - geom[8],
             std::min(geom[11], I) - geom[10]};
    if (cells != nullptr) {
        const int top[3] = {K, J, I};
        for (int a = 0; a < 3; ++a) {
            const int lo = geom[6 + 2 * a], hi = std::min(geom[7 + 2 * a], top[a]);
            if (cells[a] < 0 || cells[a] > lo || cells[a] + cells[3 + a] < hi || cells[a] + cells[3 + a] > top[a])
                return false;
        }
        g->ck0 = cells[0]; g->cj0 = cells[1]; g->ci0 = cells[2];
        g->cnk = cells[3]; g->cnj = cells[4]; g->cni = cells[5];
    }
    return true;
}

}  // namespace

// Plain C interface, loaded with ctypes: one entry point for every variant.
// dtype: 0 = float32, 1 = bfloat16.  in, out: six pointers each (ex, ey,
// ez, hx, hy, hz); out must not alias in.  K, J, I: the grid (maxk, maxj,
// maxi); geom: null for arrays of the whole grid, or a shard's 12 ints
// (see box_of), which the vacuum and material variants take, with or
// without the DFT bands (acc, sigma and the sums then cover the window's
// cells, or the cell box `cells` where it is given).  fh, fe: the vacuum H
// and E factors (fh is the H factor unless hf is given; fe is unused by
// the lossy and Debye variants).  s, bj, bi: the steps per sweep and the
// block's threads along j and i (bi = 32); cr: whether the coefficients
// ride the ring (1) or are read from memory (0), a built shape of
// ops/stream_plan.py; tk: the planes a block of ring_kernel advances (a
// grid of tk-plane segments of every tile).  ez_rows, hx_rows: (s-1) x
// (i1-i0) drive rows in the storage dtype (unused without the patch).
// Every bf16 array must start 4-byte aligned (the kernels copy aligned
// pairs).  The arrays a variant does not read are null, and the ones given
// select the variant:
//   coefs   lossy media: ca_x, ca_y, ca_z, cb_x, cb_y, cb_z (the fields'
//           shape and dtype); with pol_in, the 15 Debye maps ca_x..k2_z in
//           ops/dispersive.py::DebyeCoefs.arrays order, and with acc 18
//           (+ sig_x, sig_y, sig_z);
//   hf      heterogeneous mu_r (lossy media only): hf_x, hf_y, hf_z;
//   acc     SAR: the fp32 (K, J, I) map, updated in place with every step's
//           sigma*|E_cell|^2*dt (sigma: (K, J, I) in the storage dtype) or,
//           in Debye media, its work*dt (sigma null); dt: the step in fp32;
//   psi_in  CPML (vacuum or lossy, pml_kernel): psi_in, psi_out twelve
//           pointers each in ops/cpml.py::_TERMS order (psi_out must not
//           alias psi_in); tab_h, tab_e the (6, 2, 2n) (b, c) tables; n the
//           slab depth; blocks the nblocks entries of the block list (two
//           int4 each, see pml_kernel), which replace tk;
//   pol_in  Debye media (vacuum H): pol_in, pol_out px, py, pz each (the
//           fields' shape and dtype; pol_out must not alias pol_in);
//   re      the DFT bands (fields "e"): re, im the (nf, nc, K, J, I) fp32
//           sums, updated in place; w the sweep's (s, 2, nf) fp32 (cos,
//           sin) rows;
//   means   their means mode (re, im and w null, nf 0): the sweep's
//           (s, 3, cells) fp32 slice of the means buffer, level m's E cell
//           means written into its level m-1 (cells: those of the sums).
// The nine variants of ops/stream_plan.py::VARIANTS are built, each with
// and without the bands, and the five shard variants, each with and without
// them; with YEE_STREAM_FOLD, the bands' means mode of each of them alone.
// Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for arguments it does not take).
extern "C" {

int yee_stream_sweep(void* const* in, void* const* out, int K, int J, int I, const int* geom, const int* cells,
                     float fh, float fe, int s, int bj, int bi, int cr, int tk, int has_patch, int j0, int j1, int i0,
                     int i1, const void* ez_rows, const void* hx_rows, void* const* coefs, void* const* hf,
                     const void* sigma, void* acc, float dt, void* const* psi_in, void* const* psi_out,
                     const void* tab_h, const void* tab_e, int n, const void* blocks, int nblocks,
                     void* const* pol_in, void* const* pol_out, void* re, void* im, const void* w, int nf, int nc,
                     void* means, int dtype, void* stream) {
    const bool ade = pol_in != nullptr, lossy = coefs != nullptr && !ade, het = hf != nullptr;
    const bool sar = acc != nullptr, pml = psi_in != nullptr;
    if (bi != BI || (!pml && tk < 1) || (has_patch && (ez_rows == nullptr || hx_rows == nullptr))
        || (ade && (coefs == nullptr || pol_out == nullptr)) || ((sigma != nullptr) != (sar && !ade))
        || (pml && (psi_out == nullptr || tab_h == nullptr || tab_e == nullptr || n < 1 || blocks == nullptr
                    || nblocks < 1 || het || sar))
        || (re != nullptr && (im == nullptr || w == nullptr || nf < 1 || nc < 3 || means != nullptr))
        || (means != nullptr && (im != nullptr || w != nullptr || nf != 0)))
        return (int)cudaErrorInvalidValue;
    const int code = (lossy ? 1 : 0) | (het ? 2 : 0) | (sar ? 4 : 0) | (pml ? 8 : 0) | (ade ? 16 : 0);
    Box g;
    if ((geom != nullptr && (pml || ade))
        || !box_of(geom, cells, K, J, I, s, sar || re != nullptr || means != nullptr, &g))
        return (int)cudaErrorInvalidValue;
    const DftSweep dft{(float*)re, (float*)im, (const float*)w, nf, nc, (float*)means};
    const bool boxed = geom != nullptr;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0)
        return sweep<float>(code, s, bj, cr, in, out, K, J, I, boxed, g, fh, fe, tk, has_patch, j0, j1, i0, i1,
                            ez_rows, hx_rows, coefs, hf, sigma, acc, dt, psi_in, psi_out, tab_h, tab_e, n, blocks,
                            nblocks, pol_in, pol_out, dft, st);
    if (dtype == 1)
        return sweep<__nv_bfloat16>(code, s, bj, cr, in, out, K, J, I, boxed, g, fh, fe, tk, has_patch, j0,
                                    j1, i0, i1, ez_rows, hx_rows, coefs, hf, sigma, acc, dt, psi_in, psi_out, tab_h,
                                    tab_e, n, blocks, nblocks, pol_in, pol_out, dft, st);
    return (int)cudaErrorInvalidValue;
}

const char* yee_stream_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
