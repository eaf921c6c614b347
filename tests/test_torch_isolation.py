"""The port stands alone: no file of llama_cpp_gfx906_tpu_torch, nor
chip_smoke.py, imports jax or the JAX package; the package imports with
both blocked; and its entry points default to the card, raising where
there is none instead of falling back to the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "llama_cpp_gfx906_tpu_torch"
FORBIDDEN = ("jax", "llama_cpp_gfx906_tpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path)
           if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]
    assert not bad, f"{path} imports {bad}"


def test_package_imports_with_jax_blocked():
    code = f"""
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {FORBIDDEN!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {str(ROOT)!r})
import llama_cpp_gfx906_tpu_torch as pkg
mods = []
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
    mods.append(m.name)
assert "llama_cpp_gfx906_tpu_torch.runtime.engine" in mods, mods
assert not any(k.split(".")[0] in {FORBIDDEN!r} for k in sys.modules)
print(len(mods))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_engine_defaults_to_the_card(no_cuda):
    from llama_cpp_gfx906_tpu_torch.device import resolve_device
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine.from_gguf(str(ROOT / "tests" / "fixtures" / "tinydoc-byte.f16.gguf"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_refuses_without_card(no_cuda):
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""
