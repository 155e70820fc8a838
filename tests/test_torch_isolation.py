"""The port stands alone: it imports neither JAX nor the JAX package, and
chip_smoke.py refuses to run without a GPU or without the package."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "fdtd_tpu_torch")
MODULES = sorted(
    "fdtd_tpu_torch." + os.path.relpath(os.path.join(d, f), PKG)[:-3].replace(os.sep, ".")
    for d, _, files in os.walk(PKG)
    for f in files
    if f.endswith(".py") and f != "__main__.py"
)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    return env


def test_import_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m.replace('.__init__', ''))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'fdtd_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=_env(),
                       cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    assert len(MODULES) >= 20


@pytest.mark.parametrize("path", [os.path.relpath(os.path.join(PKG, m.split(".", 1)[1].replace(".", os.sep) + ".py"), REPO)
                                  for m in MODULES] + ["chip_smoke.py"])
def test_no_import_line_names_jax(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "fdtd_tpu"), (path, name)


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        return  # on a card the script is the smoke test itself
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], capture_output=True,
                       text=True, cwd=tmp_path, env=_env(), timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "is_available" in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the repo
    it exits non-zero with no result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                       cwd=tmp_path, env=env, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
