"""Compare the machine code (SASS) of the CUDA kernels of two checkouts.

    python -m fdtd_tpu_torch.sass_compare OTHER_CHECKOUT [--json OUT] [--alias PATTERN NAME]

Builds ``csrc/<name>.cu`` of this package and of ``OTHER_CHECKOUT`` (a
checkout of another commit, e.g. unpacked with ``git archive``) to cubins
with the flags of :mod:`fdtd_tpu_torch.ops.build`, one nvcc per source, all
started together, dumps them with ``cuobjdump -sass`` and compares every
kernel the other checkout has with the kernel of the same name here,
instruction by instruction.  Names are demangled (``cu++filt``) without
the anonymous namespace, and a template argument ``false`` appended in
this checkout (a new trailing flag, such as ``BOX``, off) still matches;
``--alias PATTERN NAME`` (a regular expression over the other checkout's
name and its expansion here, e.g. for template flags this checkout
dropped) names the counterpart of a renamed kernel.
The instruction text drops addresses, encodings and the offsets of the
kernel parameters in constant bank 0 (a parameter added to a kernel may
move the others).  A report: prints one line a kernel that differs or is
missing and a JSON summary line per source, and exits 1 only when a kernel
of the other checkout has no counterpart here (a kernel may differ on
purpose; which ones should is the reader's call).  Needs nvcc, cuobjdump and
cu++filt (the CUDA toolkit).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from .ops import build

SOURCES = ("yee_twopass", "yee_stream", "dft_accum")
_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;")
_PARAM = re.compile(r"c\[0x0\]\[0x[0-9a-f]+\]")


def tool(name: str) -> str:
    nvcc = build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc was not found; the comparison needs the CUDA toolkit")
    return str(Path(nvcc).with_name(name))


def cubin(src: Path, out: Path) -> Path:
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    r = subprocess.run([tool("nvcc"), *flags, "-cubin", "-o", str(out), str(src)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stderr}")
    return out


def kernels(path: Path) -> dict[str, list[str]]:
    """Demangled kernel name (without the anonymous namespace, template
    arguments without their casts: ``2``, ``true``) -> its instructions,
    parameter offsets blanked."""
    dump = subprocess.run([tool("cuobjdump"), "-sass", str(path)], capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in dump.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if cur is not None and m:
            cur.append(_PARAM.sub("c[0x0][PARAM]", m.group(1)))
    names = list(funcs)
    plain = subprocess.run([tool("cu++filt")], input="\n".join(names), capture_output=True, text=True,
                           check=True).stdout.splitlines()
    return {_uncast(_strip_args(re.sub(r"\(anonymous namespace\)::|<unnamed>::", "", d))): funcs[n]
            for n, d in zip(names, plain)}


def _uncast(name: str) -> str:
    """Template arguments as written: some demanglers print ``(int)2`` and
    ``(bool)1`` for ``2`` and ``true``."""
    name = re.sub(r"\(bool\)0", "false", re.sub(r"\(bool\)1", "true", name))
    return re.sub(r"\(int\)(-?\d+)", r"\1", name)


def _strip_args(name: str) -> str:
    """A demangled kernel name without its parameter list."""
    depth = 0
    for q in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[q], 0)
        if depth == 0 and name[q] == "(":
            return name[:q]
    return name


def match(name: str, here: dict, aliases: list[tuple[str, str]] = ()) -> str | None:
    """The kernel here of the other checkout's ``name``: an alias's
    expansion, the same name, or the name with a trailing template argument
    ``false`` added."""
    for pattern, repl in aliases:
        m = re.fullmatch(pattern, name)
        if m is not None:
            return m.expand(repl) if m.expand(repl) in here else None
    if name in here:
        return name
    cand = name[:-1] + ", false>"
    return cand if name.endswith(">") and cand in here else None


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="the other checkout (its fdtd_tpu_torch/csrc is compared)")
    ap.add_argument("--json", default=None, help="write the per-kernel verdicts here")
    ap.add_argument("--alias", nargs=2, action="append", default=[], metavar=("PATTERN", "NAME"),
                    help="the kernel here of the other checkout's kernels that PATTERN matches (re.fullmatch; "
                         "NAME may use its groups, \\1 ...)")
    args = ap.parse_args(argv)
    other = Path(args.other) / "fdtd_tpu_torch" / "csrc"
    missing_total = 0
    verdicts = {}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(2 * len(SOURCES)) as pool:
        jobs = {}
        for name in SOURCES:
            jobs[name] = (pool.submit(cubin, build.CSRC_DIR / f"{name}.cu", Path(tmp) / f"{name}.here.cubin"),
                          pool.submit(cubin, other / f"{name}.cu", Path(tmp) / f"{name}.other.cubin"))
        for name, (f_here, f_other) in jobs.items():
            here, there = kernels(f_here.result()), kernels(f_other.result())
            same, differ, missing = 0, [], []
            for k, insns in there.items():
                m = match(k, here, args.alias)
                if m is None:
                    missing.append(k)
                elif here[m] == insns:
                    same += 1
                else:
                    differ.append(k)
                verdicts[f"{name}: {k}"] = "missing" if m is None else "same" if here[m] == insns else "differs"
            for k in differ + missing:
                print(f"{name}: {k}: {'differs' if k in differ else 'missing here'}")
            missing_total += len(missing)
            print(json.dumps({"source": name, "kernels_compared": len(there), "same": same,
                              "differ": len(differ), "missing": len(missing),
                              "new_here": len(here) - same - len(differ)}))
    if args.json:
        Path(args.json).write_text(json.dumps(verdicts, indent=1))
    return 1 if missing_total else 0


if __name__ == "__main__":
    sys.exit(main())
