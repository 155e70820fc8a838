"""Names of the program's device kernels, as a profiler trace shows them.

A frozen copy of ``fdtd_tpu_torch/profile_chunk.py``'s ``_group`` (and
of the ``stream_plan.variant_name`` it calls): the demangled name of a
kernel of ``fdtd_tpu_torch/csrc/`` becomes its launch-counter name
(``yee_stream``, ``yee_stream_lossy_sar``, ``yee_update_h``, ...), with
``dft_fold`` added; any other kernel keeps a short form of its own name.
Frozen so that the benchmark names the kernels the same way whatever a
later change does to the program's tools.
"""

from __future__ import annotations

import re

_KERNEL = re.compile(r"::(pml_kernel|ring_kernel|march_kernel|h_kernel|e_kernel|ade_e_kernel|dft_accum_kernel"
                     r"|dft_fold_kernel)<([^>]*)>")
# the kernels that advance the fields (the sweeps and the two passes)
FIELD_UPDATE = frozenset({"ring_kernel", "pml_kernel", "march_kernel", "h_kernel", "e_kernel", "ade_e_kernel"})
# the kernels of the DFT monitors: the per-step sums and the means mode's fold
DFT = frozenset({"dft_fold_kernel", "dft_accum_kernel"})


def base(name: str) -> str | None:
    """The csrc kernel function a demangled name calls, or None."""
    m = _KERNEL.search(name)
    return m.group(1) if m else None


def _variant(lossy: bool, het: bool, sar: bool, pml: bool = False, ade: bool = False, dft: bool = False) -> str:
    suffix = "_dft" if dft else ""
    if ade:
        return "yee_stream_ade" + ("_sar" if sar else "") + suffix
    stem = "yee_stream" if not lossy else "yee_stream_lossy" + ("_het" if het else "") + ("_sar" if sar else "")
    return stem + ("_pml" if pml else "") + suffix


def group(name: str, pml: bool = False, shard: bool = False) -> str:
    """The launch-counter name of a csrc kernel, else ``other`` (``pml``:
    a CPML scene, whose box sweeps are the CPML sweep's interior;
    ``shard``: a sharded scene)."""
    m = _KERNEL.search(name)
    if m is None:
        return "other"
    flags = [a.strip() == "true" for a in m.group(2).split(",")[1:] if a.strip() in ("true", "false")]
    kind = m.group(1)
    if kind == "dft_fold_kernel":
        return "dft_fold"
    if kind == "dft_accum_kernel":
        return "dft_accum" + ("_shard" if flags[:1] == [True] else "")
    if kind == "pml_kernel":
        return _variant(flags[1], False, False, True, False, flags[2])
    if kind == "ring_kernel":
        lossy, het, sar, ade, dft, box = flags[1:7]
        if box and pml:
            return _variant(lossy, het, sar, True, ade, dft) + "_interior"
        return _variant(lossy, het, sar, False, ade, dft) + ("_shard" if box else "")
    if kind == "ade_e_kernel":
        return "yee_update_e_ade" + ("_sar" if flags[0] else "")
    if kind == "march_kernel":
        e, mat, pml_pass = flags[:3]
        if flags[3:4] == [True]:
            return "yee_update_e_batch" if e else "yee_update_h_batch"
        return ({(False, False): "yee_update_h", (False, True): "yee_update_h_het", (True, False): "yee_update_e",
                 (True, True): "yee_update_e_lossy"}[e, mat] + ("_pml" if pml_pass else "")
                + ("_shard" if shard else ""))
    suffix = "_shard" if flags[1:2] == [True] else ""
    if kind == "h_kernel":
        return ("yee_update_h_het" if flags[:1] == [True] else "yee_update_h") + suffix
    return ("yee_update_e_lossy" if flags[:1] == [True] else "yee_update_e") + suffix


def label(name: str) -> str:
    """A short name for a breakdown: the launch-counter name of a csrc
    kernel, else the kernel's own name up to its template or argument list
    (at most 60 characters)."""
    g = group(name)
    if g != "other":
        return g
    short = re.split(r"[<(]", name, maxsplit=1)[0].strip() or name
    return short[-60:]
