"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded through ``ctypes``.  The
build runs at first use, into ``build/kernels/`` at the repository root;
library names carry a hash of their sources, so an edited kernel is rebuilt
and a stale library is never loaded.  All sources build in parallel, one
``nvcc`` each.  Nothing is built or loaded at import time.

Launch counts: every kernel wrapper is registered here (:func:`counted`)
with a plain integer ``launches`` that it bumps where it launches
(:func:`count`, :func:`counts`, :func:`set_counts`); a kernel with modes
also bumps the count of the mode it launched (``flash_decode_int8`` beside
``flash_decode``).  A captured CUDA graph launches again on every replay
without running the wrappers: the kernels also count their launches on the
device (:func:`device_counts`, graph replays included), each into the
slot its registration names.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("gemv", "flash_decode", "flash_attention", "decode_stream", "qmm", "rqmm")
# --split-compile=0: optimise a source's kernels in parallel on every core
# (the decode megakernels' many instantiations built 4x faster on the card)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")

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


TILE_COUNTERS = 1 << 16  # the split-K kernels' arrival counters per device
_tile_counters: dict = {}


def tile_counters(device, n: int):
    """A buffer of at least ``n`` int32 arrival counters for the column
    tiles of a split-K launch on ``device`` (K8, and K3's split merge),
    zero at rest: the last block of a tile resets its counter, so one
    buffer per device serves every launch on its stream and every graph
    captured there.  It
    is made at the first call, which a graph capture must not be (the
    engines warm a step up eagerly before they capture it)."""
    import torch

    buf = _tile_counters.get(device)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("split-K counters: launch once before a graph capture")
        buf = _tile_counters[device] = torch.zeros(TILE_COUNTERS, dtype=torch.int32,
                                                   device=device)
    if n > buf.numel():
        raise ValueError(f"split-K counters: {n} tiles > {buf.numel()}")
    return buf


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


COUNT_SLOTS = 16  # device count slots per library (csrc/common.cuh kCountSlots)
# name -> the wrapper function whose ``launches`` attribute counts its kernel
COUNTERS: dict = {}
# (library, device count slot) -> the count names one launch there adds to
_SLOTS: dict = {}


class _ModeCount:
    launches = 0


def counted(name: str, lib: str | None = None, slot: int = 0,
            modes: tuple[str, ...] = ()):
    """Register a kernel wrapper under ``name``, with ``launches = 0``.
    ``modes`` are the kernel's flags: a launch with some of them on also
    counts as ``<name>_<the flags on, joined by _>`` (in
    ``wrapper.modes``).  On the device, the kernel of ``csrc/<lib>.cu``
    counts each launch in slot ``slot`` plus its flags as bits (bit i for
    ``modes[i]``; ``csrc/common.cuh`` ``count_launch``)."""

    def deco(fn):
        fn.launches = 0
        fn.flags = modes
        fn.modes = {}
        COUNTERS[name] = fn
        for bits in range(1 << len(modes)):
            mode = "_".join(m for i, m in enumerate(modes) if bits >> i & 1)
            if mode:
                fn.modes[mode] = COUNTERS[f"{name}_{mode}"] = _ModeCount()
            if lib is not None:
                _SLOTS[lib, slot + bits] = (name, f"{name}_{mode}") if mode else (name,)
        return fn

    return deco


def mode_count(name: str, lib: str, slot: int) -> _ModeCount:
    """Register ``name``, the count of a mode that a kernel's launch runs
    beside the flags its wrapper's :func:`counted` names (device slot
    ``slot``); :func:`count` it where that launch is counted."""
    return counted(name, lib, slot)(_ModeCount())


def count(fn, *flags: bool) -> None:
    """One launch of ``fn``'s kernel, with its mode flags in the order of
    its registered ``modes``."""
    fn.launches += 1
    mode = "_".join(m for m, on in zip(fn.flags, flags) if on)
    if mode:
        fn.modes[mode].launches += 1


def counts() -> dict:
    return {k: fn.launches for k, fn in COUNTERS.items()}


def set_counts(values: dict) -> None:
    for k, fn in COUNTERS.items():
        fn.launches = values.get(k, 0)


def device_counts() -> dict:
    """Launches that ran on the card since each library was loaded, as the
    kernels counted them on the device (graph replays included), under the
    wrappers' count names (those that count on the device); a library not
    loaded yet counts 0.  Synchronises with the legacy default stream."""
    out = {c: 0 for names in _SLOTS.values() for c in names}
    for lib_name in sorted({lib_name for lib_name, _ in _SLOTS}):
        so = _libs.get(lib_name)
        if so is None:
            continue
        vals = (ctypes.c_ulonglong * COUNT_SLOTS)()
        check(so, so.lcg_device_counts(vals), f"{lib_name}: device counts")
        for (l, s), names in _SLOTS.items():
            if l == lib_name:
                for c in names:
                    out[c] += int(vals[s])
    return out
