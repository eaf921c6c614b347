"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded through ``ctypes``.  The
build runs at first use, into ``build/kernels/`` at the repository root;
library names carry a hash of their sources, so an edited kernel is rebuilt
and a stale library is never loaded.  All sources build in parallel, one
``nvcc`` each.  Nothing is built or loaded at import time.

Launch counts: every kernel wrapper is registered here with a plain
integer ``launches`` that it bumps where it launches (:func:`counts`,
:func:`set_counts`).  A captured CUDA graph launches again on every replay
without running the wrappers; :func:`traced_launches` counts the launches
that a ``torch.profiler`` trace recorded on the device, replays included.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("gemv", "flash_decode", "flash_attention", "decode_stream", "qmm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
# name -> what ``-Xptxas -v`` reported when this process built the library
ptxas_reports: dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for f in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> None:
    """Compile every missing library, one ``nvcc`` per source, all at once."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = _lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        ptxas_reports[n] = out
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{out}")
        else:
            os.replace(tmp, _lib_path(n))
    if errors:
        raise RuntimeError("\n".join(errors))


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _libs:
        build_all((name,))
        so = ctypes.CDLL(str(_lib_path(name)))
        so.lcg_error_string.restype = ctypes.c_char_p
        so.lcg_error_string.argtypes = [ctypes.c_int]
        _libs[name] = so
    return _libs[name]


def check(so: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}: "
                           f"{so.lcg_error_string(err).decode()}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# name -> the wrapper function whose ``launches`` attribute counts its kernel
COUNTERS: dict = {}


def counted(name: str):
    """Register a kernel wrapper under ``name``, with ``launches = 0``."""

    def deco(fn):
        fn.launches = 0
        COUNTERS[name] = fn
        return fn

    return deco


def counts() -> dict:
    return {k: fn.launches for k, fn in COUNTERS.items()}


def set_counts(values: dict) -> None:
    for k, fn in COUNTERS.items():
        fn.launches = values.get(k, 0)


# device function -> (index of the template argument that tells two kernels
# apart or None, the count's name for each of its values)
_TRACE_NAMES = {
    "gemv_kernel": (1, {"false": "gemv_int8", "true": "gemv_nib4c"}),
    "flash_decode_kernel": (None, "flash_decode"),
    "flash_attention_kernel": (None, "flash_attention"),
    "decode_kernel": (2, {"true": "decode_stream", "false": "decode_step"}),
    "qmm_int8_kernel": (None, "qmm_int8"),
}


def traced_launches(prof) -> dict:
    """Launches of each counted kernel in a ``torch.profiler`` trace, read
    from the device events by the kernels' (demangled) names."""
    from torch.autograd import DeviceType

    out = {name: 0 for name in COUNTERS}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        m = re.search(r"::(\w+)<([^()]*)>\(", ev.name)
        if m is None or m.group(1) not in _TRACE_NAMES:
            continue
        arg, names = _TRACE_NAMES[m.group(1)]
        name = names if arg is None else names[m.group(2).split(",")[arg].strip()]
        out[name] = out.get(name, 0) + 1
    return out
