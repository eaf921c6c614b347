"""Numpy block codecs for the GGUF types this slice reads.

Decode covers F32, F16, Q4_0, Q8_0, Q4_K and Q6_K; encode covers F32,
F16, Q4_0 and Q8_0 (what the writer and the tests need).  Bit layouts are
fixed by the GGUF format.

- ``dequant_*`` takes raw block bytes ``(nblocks, block_bytes) uint8`` and
  returns ``(nblocks, block_size) float32``.
- ``quant_*`` takes ``(nblocks, block_size) float32`` and returns raw bytes.
- :func:`dequantize` / :func:`quantize` work on arrays whose last axis is the
  contiguous quantized axis (ggml row-major block layout).
"""

from __future__ import annotations

import numpy as np

from .constants import GGML_BLOCK_SIZES, QK_K, GGMLType


def _f16(view: np.ndarray) -> np.ndarray:
    """Reinterpret a (nblocks, 2) uint8 slice as little-endian float16 → f32."""
    return view.copy().view(np.dtype("<f2")).astype(np.float32)


def _to_f16_bytes(x: np.ndarray) -> np.ndarray:
    """float32 (n, 1) → raw f16 bytes (n, 2)."""
    return x.astype(np.dtype("<f2")).view(np.uint8)


def _safe_inv(d: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(d != 0.0, 1.0 / np.where(d != 0.0, d, 1.0), 0.0)


def dequant_q4_0(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, 0:2])
    qs = blocks[:, 2:18]
    q = np.concatenate([qs & 0x0F, qs >> 4], axis=1).astype(np.int8) - 8
    return q.astype(np.float32) * d


def quant_q4_0(x: np.ndarray) -> np.ndarray:
    # signed max-magnitude value maps to -8 (ggml convention)
    idx = np.argmax(np.abs(x), axis=1)
    mx = x[np.arange(x.shape[0]), idx]
    d = mx / -8.0
    q = np.floor(x * _safe_inv(d)[:, None] + 8.5).clip(0, 15).astype(np.uint8)
    lo, hi = q[:, :16], q[:, 16:]
    return np.concatenate([_to_f16_bytes(d[:, None]), lo | (hi << 4)], axis=1)


def dequant_q8_0(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, 0:2])
    return blocks[:, 2:34].copy().view(np.int8).astype(np.float32) * d


def quant_q8_0(x: np.ndarray) -> np.ndarray:
    d = np.abs(x).max(axis=1) / 127.0
    q = np.rint(x * _safe_inv(d)[:, None]).clip(-127, 127).astype(np.int8)
    return np.concatenate([_to_f16_bytes(d[:, None]), q.view(np.uint8)], axis=1)


def unpack_k4_scales(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpack the Q4_K 12-byte 6-bit scale/min fields into (n, 8) each.

    sub-blocks 0-3: sc = b[j] & 63, m = b[j+4] & 63
    sub-blocks 4-7: sc = (b[j+4] & 0xF) | ((b[j-4] >> 6) << 4),
                    m  = (b[j+4] >> 4)  | ((b[j]   >> 6) << 4)
    """
    b = scales.astype(np.uint8)
    sc = np.empty(b.shape[:1] + (8,), np.uint8)
    m = np.empty_like(sc)
    sc[:, :4] = b[:, :4] & 63
    m[:, :4] = b[:, 4:8] & 63
    sc[:, 4:] = (b[:, 8:12] & 0x0F) | ((b[:, 0:4] >> 6) << 4)
    m[:, 4:] = (b[:, 8:12] >> 4) | ((b[:, 4:8] >> 6) << 4)
    return sc, m


def dequant_q4_k(blocks: np.ndarray) -> np.ndarray:
    n = blocks.shape[0]
    d = _f16(blocks[:, 0:2])
    dmin = _f16(blocks[:, 2:4])
    sc, m = unpack_k4_scales(blocks[:, 4:16])
    qs = blocks[:, 16:144]
    out = np.empty((n, QK_K), np.float32)
    dl = d * sc.astype(np.float32)
    ml = dmin * m.astype(np.float32)
    for j in range(4):  # 4 chunks of 64 elements = 32 bytes
        byte = qs[:, 32 * j : 32 * (j + 1)]
        out[:, 64 * j : 64 * j + 32] = (
            (byte & 0x0F).astype(np.float32) * dl[:, 2 * j : 2 * j + 1]
            - ml[:, 2 * j : 2 * j + 1])
        out[:, 64 * j + 32 : 64 * j + 64] = (
            (byte >> 4).astype(np.float32) * dl[:, 2 * j + 1 : 2 * j + 2]
            - ml[:, 2 * j + 1 : 2 * j + 2])
    return out


def dequant_q6_k(blocks: np.ndarray) -> np.ndarray:
    n = blocks.shape[0]
    ql = blocks[:, 0:128]
    qh = blocks[:, 128:192]
    sc = blocks[:, 192:208].copy().view(np.int8).astype(np.float32)
    d = _f16(blocks[:, 208:210])
    out = np.empty((n, QK_K), np.float32)
    for half in range(2):
        lq = ql[:, 64 * half : 64 * half + 64]
        hq = qh[:, 32 * half : 32 * half + 32]
        s = sc[:, 8 * half : 8 * half + 8]
        q1 = ((lq[:, :32] & 0x0F) | (((hq >> 0) & 3) << 4)).astype(np.int16) - 32
        q2 = ((lq[:, 32:] & 0x0F) | (((hq >> 2) & 3) << 4)).astype(np.int16) - 32
        q3 = ((lq[:, :32] >> 4) | (((hq >> 4) & 3) << 4)).astype(np.int16) - 32
        q4 = ((lq[:, 32:] >> 4) | (((hq >> 6) & 3) << 4)).astype(np.int16) - 32
        for i, q in enumerate([q1, q2, q3, q4]):
            ss = np.repeat(s[:, 2 * i : 2 * i + 2], 16, axis=1)
            out[:, 128 * half + 32 * i : 128 * half + 32 * (i + 1)] = (
                q.astype(np.float32) * ss * d)
    return out


def dequant_f32(blocks: np.ndarray) -> np.ndarray:
    return blocks.reshape(blocks.shape[0], -1).copy().view(np.dtype("<f4"))


def dequant_f16(blocks: np.ndarray) -> np.ndarray:
    return (blocks.reshape(blocks.shape[0], -1).copy()
            .view(np.dtype("<f2")).astype(np.float32))


_DEQUANT = {
    GGMLType.F32: dequant_f32,
    GGMLType.F16: dequant_f16,
    GGMLType.Q4_0: dequant_q4_0,
    GGMLType.Q8_0: dequant_q8_0,
    GGMLType.Q4_K: dequant_q4_k,
    GGMLType.Q6_K: dequant_q6_k,
}

_QUANT = {
    GGMLType.F32: lambda x: np.ascontiguousarray(x, np.dtype("<f4")).view(np.uint8),
    GGMLType.F16: lambda x: np.ascontiguousarray(x.astype(np.dtype("<f2"))).view(np.uint8),
    GGMLType.Q4_0: quant_q4_0,
    GGMLType.Q8_0: quant_q8_0,
}


def dequantize(data: np.ndarray, ggml_type: GGMLType, shape: tuple[int, ...]) -> np.ndarray:
    """Decode raw GGUF tensor bytes (flat uint8) to float32 of ``shape``
    (numpy order: last axis contiguous)."""
    ggml_type = GGMLType(ggml_type)
    if ggml_type not in _DEQUANT:
        raise NotImplementedError(f"dequantize: unsupported type {ggml_type.name}")
    blck, bsize = GGML_BLOCK_SIZES[ggml_type]
    n_elem = int(np.prod(shape)) if shape else 1
    n_blocks = n_elem // blck
    if n_blocks * bsize != data.size:
        raise ValueError(f"{ggml_type.name}: got {data.size} bytes for {n_elem} "
                         f"elements (expected {n_blocks * bsize})")
    return _DEQUANT[ggml_type](data.reshape(n_blocks, bsize)).reshape(shape)


def quantize(x: np.ndarray, ggml_type: GGMLType) -> np.ndarray:
    """Encode a float32 array into raw GGUF block bytes (flat uint8)."""
    ggml_type = GGMLType(ggml_type)
    if ggml_type not in _QUANT:
        raise NotImplementedError(f"quantize: unsupported type {ggml_type.name}")
    blck, _ = GGML_BLOCK_SIZES[ggml_type]
    n_elem = x.size
    if n_elem % blck:
        raise ValueError(f"{ggml_type.name}: {n_elem} elements not divisible by "
                         f"block {blck} (tensor shape {x.shape})")
    flat = np.ascontiguousarray(x, np.float32).reshape(n_elem // blck, blck)
    return _QUANT[ggml_type](flat).reshape(-1)
