"""Build the CUDA sources under ``csrc/`` with nvcc at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``_build/lib<name>-<hash>.so`` (the hash covers the source and the
flags, so an edited source never loads a stale library), then loaded with
``ctypes``.  ``defines`` adds preprocessor macros (``-D``) to a build of
its own, such as the candidate block shapes ``tune_stream`` times.  Nothing is compiled when the package is imported: the first
kernel launch builds.  There is no fallback: without nvcc, or when the
compiler fails, :func:`build` raises ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# sm_90a (Hopper) only; -fmad=false keeps every multiply and add separately
# rounded, so the kernels are bit-equal to their plain torch versions.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str | None:
    """nvcc under ``$CUDA_HOME`` when that is set, else under
    /usr/local/cuda, else on ``PATH``."""
    home = os.environ.get("CUDA_HOME")
    homes = [home] if home else ["/usr/local/cuda"]
    for h in homes:
        cand = os.path.join(h, "bin", "nvcc")
        if os.access(cand, os.X_OK):
            return cand
    return None if home else shutil.which("nvcc")


def _flags(defines: tuple[str, ...]) -> tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(name: str, build_dir: Path = BUILD_DIR, defines: tuple[str, ...] = ()) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + "\0".join(_flags(defines)).encode()).hexdigest()[:12]
    return Path(build_dir) / f"lib{name}-{digest}.so"


def build(name: str, build_dir: Path = BUILD_DIR, defines: tuple[str, ...] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` (with the macros ``defines``) unless its
    library is already built; the compiler's output (with ptxas register
    and spill counts) goes to a ``.log`` beside the library."""
    out = library_path(name, build_dir, defines)
    if out.exists():
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build the CUDA kernels of {name}.cu: nvcc was not found "
            "(looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH) and no "
            f"built library exists at {out}"
        )
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *_flags(defines), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + r.stdout + r.stderr)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu (exit {r.returncode}):\n{r.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib


def launch_stream(device: torch.device) -> int:
    """The handle of ``device``'s current CUDA stream, the one a kernel on
    that device's tensors launches on (under ``torch.cuda.device(device)``),
    whatever the current device is."""
    return torch.cuda.current_stream(device).cuda_stream
