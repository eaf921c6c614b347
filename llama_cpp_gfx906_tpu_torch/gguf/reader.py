"""GGUF reader: numpy-memmap parser for GGUF v2/v3 files (and multi-split
shards).  Metadata is parsed eagerly; tensor data stays memmap'd, so weights
stream from the page cache to the device without a second host copy.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np

from .constants import (
    GGML_BLOCK_SIZES,
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGMLType,
    GGUFValueType,
    Keys,
)
from . import quants

_SCALAR_FMT: dict[GGUFValueType, str] = {
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

_SCALAR_NP: dict[GGUFValueType, np.dtype] = {
    t: np.dtype(f.replace("?", "b")) for t, f in _SCALAR_FMT.items()
}


@dataclass
class TensorInfo:
    """One tensor entry: logical numpy shape + memmap'd raw bytes."""

    name: str
    shape: tuple[int, ...]  # numpy order (last axis contiguous)
    ne: tuple[int, ...]  # GGUF order (first axis contiguous) as stored
    ggml_type: GGMLType
    offset: int  # absolute file offset of the data
    data: np.ndarray = field(repr=False, default=None)  # uint8 memmap view

    @property
    def n_elements(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def n_bytes(self) -> int:
        blck, bsize = GGML_BLOCK_SIZES[self.ggml_type]
        return self.n_elements // blck * bsize

    def to_f32(self) -> np.ndarray:
        """Dequantize to a float32 array of ``self.shape``."""
        return quants.dequantize(np.asarray(self.data), self.ggml_type, self.shape)


class _Cursor:
    """Sequential little-endian decoder over a memmap."""

    def __init__(self, buf: np.ndarray):
        self.buf = buf
        self.pos = 0

    def read_fmt(self, fmt: str):
        size = struct.calcsize(fmt)
        val = struct.unpack_from(fmt, self.buf, self.pos)[0]
        self.pos += size
        return val

    def read_str(self) -> str:
        n = self.read_fmt("<Q")
        raw = bytes(self.buf[self.pos : self.pos + n])
        self.pos += n
        return raw.decode("utf-8", errors="replace")

    def read_value(self, vtype: GGUFValueType):
        if vtype == GGUFValueType.STRING:
            return self.read_str()
        if vtype == GGUFValueType.ARRAY:
            elem_type = GGUFValueType(self.read_fmt("<I"))
            count = self.read_fmt("<Q")
            if elem_type == GGUFValueType.STRING:
                return [self.read_str() for _ in range(count)]
            if elem_type == GGUFValueType.ARRAY:
                return [self.read_value(elem_type) for _ in range(count)]
            dt = _SCALAR_NP[elem_type]
            arr = (
                np.frombuffer(self.buf, dtype=dt, count=count, offset=self.pos)
                .copy()
            )
            self.pos += count * dt.itemsize
            if elem_type == GGUFValueType.BOOL:
                arr = arr.astype(bool)
            return arr
        return self.read_fmt(_SCALAR_FMT[vtype])


class GGUFReader:
    """Parse one GGUF file; tensor data is exposed as uint8 memmap views."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        self.buf = np.memmap(self.path, mode="r")
        cur = _Cursor(self.buf)
        magic = cur.read_fmt("<I")
        if magic != GGUF_MAGIC:
            raise ValueError(f"{self.path}: bad GGUF magic {magic:#x}")
        self.version = cur.read_fmt("<I")
        if self.version not in (2, 3):
            raise ValueError(f"{self.path}: unsupported GGUF version {self.version}")
        n_tensors = cur.read_fmt("<Q")
        n_kv = cur.read_fmt("<Q")

        self.metadata: dict[str, object] = {}
        for _ in range(n_kv):
            key = cur.read_str()
            vtype = GGUFValueType(cur.read_fmt("<I"))
            self.metadata[key] = cur.read_value(vtype)

        self.alignment = int(self.metadata.get(Keys.General.ALIGNMENT, GGUF_DEFAULT_ALIGNMENT))

        self.tensors: dict[str, TensorInfo] = {}
        infos = []
        for _ in range(n_tensors):
            name = cur.read_str()
            n_dims = cur.read_fmt("<I")
            ne = tuple(cur.read_fmt("<Q") for _ in range(n_dims))
            ggml_type = GGMLType(cur.read_fmt("<I"))
            offset = cur.read_fmt("<Q")
            infos.append((name, ne, ggml_type, offset))

        data_start = cur.pos + (-cur.pos) % self.alignment
        for name, ne, ggml_type, offset in infos:
            shape = tuple(reversed(ne))
            info = TensorInfo(
                name=name,
                shape=shape,
                ne=ne,
                ggml_type=ggml_type,
                offset=data_start + offset,
            )
            info.data = self.buf[info.offset : info.offset + info.n_bytes]
            self.tensors[name] = info

    # -- metadata helpers ---------------------------------------------------

    @property
    def architecture(self) -> str:
        return str(self.metadata.get(Keys.General.ARCHITECTURE, ""))

    def get(self, key: str, default=None, arch: str | None = None):
        """Look up a KV, substituting ``{arch}`` if present in the key."""
        if "{arch}" in key:
            key = key.format(arch=arch or self.architecture)
        return self.metadata.get(key, default)


def split_path_for(path: str, split_no: int, split_count: int) -> str:
    """Build the shard filename ``model-00001-of-00003.gguf`` style."""
    base = path
    for probe in ("-00001-of-", "-00002-of-"):
        idx = base.find(probe)
        if idx >= 0:
            base = base[:idx]
            break
    else:
        if base.endswith(".gguf"):
            base = base[:-5]
        return f"{base}-{split_no + 1:05d}-of-{split_count:05d}.gguf"
    return f"{base}-{split_no + 1:05d}-of-{split_count:05d}.gguf"


class GGUFModelReader:
    """Reader over a (possibly multi-split) GGUF model.

    Mirrors the semantics of the reference's split loading
    (``src/llama-model-loader.cpp:524-599``): the first shard carries the
    full metadata; every shard contributes tensors to one unified index.
    """

    def __init__(self, path: str | os.PathLike):
        first = GGUFReader(path)
        self.readers = [first]
        self.metadata = first.metadata
        self.alignment = first.alignment
        self.architecture = first.architecture
        self.tensors: dict[str, TensorInfo] = dict(first.tensors)

        split_count = int(first.metadata.get(Keys.Split.COUNT, 0) or 0)
        if split_count > 1:
            for i in range(1, split_count):
                shard = GGUFReader(split_path_for(os.fspath(path), i, split_count))
                self.readers.append(shard)
                for name, info in shard.tensors.items():
                    if name in self.tensors:
                        raise ValueError(f"duplicate tensor {name} in split {i}")
                    self.tensors[name] = info
            want = int(first.metadata.get(Keys.Split.TENSORS_COUNT, 0) or 0)
            if want and want != len(self.tensors):
                raise ValueError(
                    f"split model has {len(self.tensors)} tensors, expected {want}"
                )

    def get(self, key: str, default=None, arch: str | None = None):
        if "{arch}" in key:
            key = key.format(arch=arch or self.architecture)
        return self.metadata.get(key, default)
