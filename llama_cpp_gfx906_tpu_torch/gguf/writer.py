"""GGUF writer: produce v3 files from numpy tensors.

Values are buffered, then serialized in one pass: metadata KVs, typed
arrays, tensor infos, and aligned tensor data.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_VERSION,
    GGMLType,
    GGUFValueType,
    Keys,
)
from . import quants

_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}


def _guess_vtype(value) -> GGUFValueType:
    if isinstance(value, bool) or isinstance(value, np.bool_):
        return GGUFValueType.BOOL
    if isinstance(value, (int, np.integer)):
        return GGUFValueType.INT64 if value < 0 else GGUFValueType.UINT32 if value < 2**32 else GGUFValueType.UINT64
    if isinstance(value, (float, np.floating)):
        return GGUFValueType.FLOAT32
    if isinstance(value, str):
        return GGUFValueType.STRING
    if isinstance(value, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot infer GGUF value type for {type(value)}")


_NP_TO_VTYPE = {
    np.dtype(np.uint8): GGUFValueType.UINT8,
    np.dtype(np.int8): GGUFValueType.INT8,
    np.dtype(np.uint16): GGUFValueType.UINT16,
    np.dtype(np.int16): GGUFValueType.INT16,
    np.dtype(np.uint32): GGUFValueType.UINT32,
    np.dtype(np.int32): GGUFValueType.INT32,
    np.dtype(np.float32): GGUFValueType.FLOAT32,
    np.dtype(np.uint64): GGUFValueType.UINT64,
    np.dtype(np.int64): GGUFValueType.INT64,
    np.dtype(np.float64): GGUFValueType.FLOAT64,
}


def _write_str(out: list[bytes], s: str) -> None:
    raw = s.encode("utf-8")
    out.append(struct.pack("<Q", len(raw)))
    out.append(raw)


def _write_value(out: list[bytes], value, vtype: GGUFValueType | None = None) -> None:
    vtype = vtype or _guess_vtype(value)
    out.append(struct.pack("<I", int(vtype)))
    _write_value_body(out, value, vtype)


def _write_value_body(out: list[bytes], value, vtype: GGUFValueType) -> None:
    if vtype == GGUFValueType.STRING:
        _write_str(out, value)
    elif vtype == GGUFValueType.ARRAY:
        if isinstance(value, np.ndarray) and value.dtype in _NP_TO_VTYPE:
            elem_t = _NP_TO_VTYPE[value.dtype]
            out.append(struct.pack("<IQ", int(elem_t), value.size))
            out.append(np.ascontiguousarray(value).tobytes())
        else:
            seq = list(value)
            if not seq:
                elem_t = GGUFValueType.INT32
            elif isinstance(seq[0], str):
                elem_t = GGUFValueType.STRING
            elif isinstance(seq[0], (float, np.floating)):
                elem_t = GGUFValueType.FLOAT32
            elif isinstance(seq[0], (bool, np.bool_)):
                elem_t = GGUFValueType.BOOL
            else:
                elem_t = GGUFValueType.INT32
            out.append(struct.pack("<IQ", int(elem_t), len(seq)))
            for item in seq:
                _write_value_body(out, item, elem_t)
    else:
        out.append(struct.pack(_SCALAR_FMT[vtype], value))


@dataclass
class _PendingTensor:
    name: str
    ne: tuple[int, ...]
    ggml_type: GGMLType
    data: np.ndarray  # encoded bytes, flat uint8 (written without a copy)


class GGUFWriter:
    """Accumulate metadata + tensors, then :meth:`write` a GGUF v3 file."""

    def __init__(self, path: str | os.PathLike, arch: str, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.path = os.fspath(path)
        self.arch = arch
        self.alignment = alignment
        self.kv: list[tuple[str, object, GGUFValueType | None]] = []
        self.tensors: list[_PendingTensor] = []
        self.add_kv(Keys.General.ARCHITECTURE, arch)

    # -- metadata -----------------------------------------------------------

    def add_kv(self, key: str, value, vtype: GGUFValueType | None = None) -> None:
        if "{arch}" in key:
            key = key.format(arch=self.arch)
        self.kv.append((key, value, vtype))

    def add_uint32(self, key: str, value: int) -> None:
        self.add_kv(key, int(value), GGUFValueType.UINT32)

    def add_float32(self, key: str, value: float) -> None:
        self.add_kv(key, float(value), GGUFValueType.FLOAT32)

    def add_bool(self, key: str, value: bool) -> None:
        self.add_kv(key, bool(value), GGUFValueType.BOOL)

    def add_string(self, key: str, value: str) -> None:
        self.add_kv(key, str(value), GGUFValueType.STRING)

    def add_array(self, key: str, value) -> None:
        self.add_kv(key, value, GGUFValueType.ARRAY)

    # -- tensors ------------------------------------------------------------

    def add_tensor(
        self,
        name: str,
        array: np.ndarray,
        ggml_type: GGMLType | None = None,
        raw_ne: tuple[int, ...] | None = None,
    ) -> None:
        """Add a tensor.

        ``array`` is numpy-ordered (last axis contiguous); it is encoded to
        ``ggml_type`` (default: F32 stays F32, f16 stays F16, everything
        else F32).  Pass ``raw_ne`` + uint8 ``array`` to store pre-encoded
        block data verbatim.
        """
        if array.dtype == np.uint8 and raw_ne is not None:
            if ggml_type is None:
                raise ValueError("raw tensor data needs its ggml_type")
            data = np.ascontiguousarray(array).reshape(-1)
            self.tensors.append(_PendingTensor(name, tuple(raw_ne), ggml_type, data))
            return
        if ggml_type is None:
            ggml_type = GGMLType.F16 if array.dtype == np.float16 else GGMLType.F32
        data = quants.quantize(np.asarray(array, np.float32), ggml_type)
        ne = tuple(reversed(array.shape))
        self.tensors.append(_PendingTensor(name, ne, ggml_type, data))

    # -- serialization ------------------------------------------------------

    def write(self) -> str:
        out: list[bytes] = []
        out.append(struct.pack("<IIQQ", GGUF_MAGIC, GGUF_VERSION, len(self.tensors), len(self.kv)))
        for key, value, vtype in self.kv:
            _write_str(out, key)
            _write_value(out, value, vtype)

        offset = 0
        offsets = []
        for t in self.tensors:
            offsets.append(offset)
            offset += t.data.nbytes
            offset += (-offset) % self.alignment
        for t, off in zip(self.tensors, offsets):
            _write_str(out, t.name)
            out.append(struct.pack("<I", len(t.ne)))
            out.append(struct.pack(f"<{len(t.ne)}Q", *t.ne))
            out.append(struct.pack("<IQ", int(t.ggml_type), off))

        header = b"".join(out)
        pad0 = (-len(header)) % self.alignment
        with open(self.path, "wb") as f:
            f.write(header)
            f.write(b"\x00" * pad0)
            pos = 0
            for t, off in zip(self.tensors, offsets):
                f.write(b"\x00" * (off - pos))
                f.write(t.data)
                pos = off + t.data.nbytes
        return self.path
