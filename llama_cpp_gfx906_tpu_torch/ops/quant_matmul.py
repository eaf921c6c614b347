"""Quantized weights on the device and the quantized matmul.

Port of ``llama_cpp_gfx906_tpu/ops/quant_matmul.py``.  Device planes are
byte-identical to the JAX package's (so parity compares the same bytes):

- ``int8``  : q int8 (K, N);  w[k, n] = q[k, n] * s[k//g, n] - m[k//g, n]
- ``nib4c`` : q int8 (K/2, N), chunk-local biased 4-bit packing: within each
  CK-row chunk, logical row k pairs with k + CK/2 in one byte stored as
  ``(lo | hi << 4) ^ 0x80``.

Scales are plain f32 (K/g, N) planes, or folded: int8 sub-scales times f32
super-planes ``sd`` at K/128 rows (each per-256 ``d`` repeated twice), and
likewise for the optional mins.

Compute: a matmul with M <= 8 rows of x goes to the hand-written GEMV
kernels (K1 ``gemv_int8``, K2 ``gemv_nib4c``, ``csrc/gemv.cu``) for every
weight size; the JAX package's ``K*N >= 2**23`` gate is a TPU launch-overhead
heuristic and is not carried over.  M > 8 (prefill) on the card goes to the
tiled dequant matmul K5 (``qmm_int8``, ``csrc/qmm.cu``) for the weights the
JAX package gives its K5 (int8 with plain scales, on its tile grid:
:func:`qmm_tileable`); every other weight, and every M > 8 matmul on the
CPU, dequantizes to bf16 and calls ``torch.matmul``, as the JAX package
leaves those to XLA's dequant-dot.  Grid decoding runs in torch, so it runs
on the card when the planes are built there.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch import nn

from .. import kernels
from ..gguf.constants import GGML_BLOCK_SIZES, QK_K, GGMLType


class QuantTensor(nn.Module):
    """Block-quantized weight used as ``x @ qt`` (see the module docstring
    for the plane layouts).  ``shape`` is the logical (K, N); ``q`` may carry
    zero pad columns past N (:func:`pad_qt_n`)."""

    def __init__(self, q, s, m, fmt: str, group: int, shape, sd=None, md=None,
                 sgroup: int = 0):
        super().__init__()
        for name, t in (("q", q), ("s", s), ("m", m), ("sd", sd), ("md", md)):
            self.register_buffer(name, t)
        self.fmt = fmt
        self.group = int(group)
        self.shape = (int(shape[0]), int(shape[1]))
        self.sgroup = int(sgroup)

    @property
    def K(self) -> int:
        return self.shape[0]

    @property
    def N(self) -> int:
        return self.shape[1]


# ---------------------------------------------------------------------------
# GGUF raw blocks -> (values, scales, mins) grids, in torch
# ---------------------------------------------------------------------------
# Each decoder takes (nblocks, block_bytes) uint8 and returns values int8
# (n, blck), scales f32 (n, blck//g), mins f32 or None, and g, such that
# dequant == values * repeat(scales) - repeat(mins).


def _f16(b2: torch.Tensor) -> torch.Tensor:
    """(n, 2) uint8 little-endian float16 -> (n, 1) f32."""
    return b2.contiguous().view(torch.float16).float()


def _unpack_k4_scales(b: torch.Tensor):
    """Q4_K 12-byte 6-bit scale/min fields -> (sc, m) uint8 (n, 8) each."""
    sc = torch.cat([b[:, :4] & 63, (b[:, 8:12] & 0x0F) | ((b[:, 0:4] >> 6) << 4)], 1)
    m = torch.cat([b[:, 4:8] & 63, (b[:, 8:12] >> 4) | ((b[:, 4:8] >> 6) << 4)], 1)
    return sc, m


def _grid_q8_0(b):
    return b[:, 2:34].contiguous().view(torch.int8), _f16(b[:, 0:2]), None, 32


def _grid_q4_0(b):
    d = _f16(b[:, 0:2])
    qs = b[:, 2:18]
    q = torch.cat([qs & 0x0F, qs >> 4], 1).to(torch.int8)
    return q, d, 8.0 * d, 32


def _grid_q4_k(b):
    n = b.shape[0]
    d, dmin = _f16(b[:, 0:2]), _f16(b[:, 2:4])
    sc, m = _unpack_k4_scales(b[:, 4:16])
    qs = b[:, 16:144].reshape(n, 4, 1, 32)
    q = torch.cat([qs & 0x0F, qs >> 4], 2).reshape(n, QK_K).to(torch.int8)
    return q, d * sc.float(), dmin * m.float(), 32


def _grid_q6_k(b):
    n = b.shape[0]
    ql = b[:, 0:128].reshape(n, 2, 2, 32)   # (half, lo/hi 32-byte strip)
    qh = b[:, 128:192].reshape(n, 2, 1, 32)
    strips = [(ql[:, :, 0] & 0x0F), (ql[:, :, 1] & 0x0F),
              (ql[:, :, 0] >> 4), (ql[:, :, 1] >> 4)]
    q = torch.stack([s | (((qh[:, :, 0] >> (2 * i)) & 3) << 4)
                     for i, s in enumerate(strips)], 2)  # (n, 2, 4, 32)
    q = (q.reshape(n, QK_K).to(torch.int16) - 32).to(torch.int8)
    sc = b[:, 192:208].contiguous().view(torch.int8).float()
    return q, _f16(b[:, 208:210]) * sc, None, 16


_GRID_DECODERS = {
    GGMLType.Q8_0: _grid_q8_0,
    GGMLType.Q4_0: _grid_q4_0,
    GGMLType.Q4_K: _grid_q4_k,
    GGMLType.Q6_K: _grid_q6_k,
}

# formats whose values fit unsigned nibbles -> stay 4-bit packed on device
_NIB4_TYPES = {GGMLType.Q4_0, GGMLType.Q4_K}


def _parts_q4_k(b):
    sc, m = _unpack_k4_scales(b[:, 4:16])
    return (sc.to(torch.int8), _f16(b[:, 0:2]), m.to(torch.int8),
            _f16(b[:, 2:4]), 32)


def _parts_q6_k(b):
    return (b[:, 192:208].contiguous().view(torch.int8), _f16(b[:, 208:210]),
            None, None, 16)


# k-quant scale parts kept raw on device when folding:
# (sc int8, d f32 per block, m int8 | None, dmin f32 | None, g)
_SCALE_PART_DECODERS = {
    GGMLType.Q4_K: _parts_q4_k,
    GGMLType.Q6_K: _parts_q6_k,
}


def supported_qmm_types() -> list[GGMLType]:
    return sorted(_GRID_DECODERS)


def nib4c_chunk(K: int) -> int | None:
    """Chunk size (logical K rows) of the chunk-local 4-bit packing."""
    return next((t for t in (2048, 1024, 512, 256) if K % t == 0), None)


def _pack_nib4c(qT: torch.Tensor, ck: int) -> torch.Tensor:
    """(K, N) uint8 nibble values -> (K/2, N) chunk-local biased int8."""
    K, N = qT.shape
    v = qT.reshape(K // ck, 2, ck // 2, N)
    return ((v[:, 0] | (v[:, 1] << 4)) ^ 0x80).reshape(K // 2, N).view(torch.int8)


def _fold_streams(K: int, ggml_type) -> bool:
    """The JAX package's per-tensor fold rule: folded scales only where its
    streamed kernels can consume them (kept so both packages pack alike)."""
    if ggml_type in _NIB4_TYPES:
        ck = nib4c_chunk(K)
        return ck is not None and (ck == K or (ck // 128) % 8 == 0)
    tk = next((t for t in (1024, 512, 256) if K % t == 0), None)
    return tk is not None and (tk == K or tk % 1024 == 0)


def _as_blocks(raw, bsize: int, device) -> torch.Tensor:
    if isinstance(raw, np.ndarray):
        raw = torch.from_numpy(np.array(raw, np.uint8, copy=True))
    return raw.to(device).reshape(-1, bsize)


def pack_gguf_tensor(raw, ggml_type, shape, fold_scales: bool = False,
                     device="cpu") -> QuantTensor:
    """Decode GGUF block bytes of an (N, K) weight into a QuantTensor.

    GGUF stores weights (out=N, in=K) with K contiguous; the matmul consumes
    (K, N), so the grids are transposed here.  ``fold_scales`` keeps the
    k-quant scale structure (int8 sub-scales + f32 super-planes); other types
    ignore it."""
    N, K = int(np.prod(shape[:-1])), int(shape[-1])
    ggml_type = GGMLType(ggml_type)
    _, bsize = GGML_BLOCK_SIZES[ggml_type]
    blocks = _as_blocks(raw, bsize, device)
    q, s, m, g = _GRID_DECODERS[ggml_type](blocks)
    q = q.reshape(N, K)
    s = s.reshape(N, K // g)
    m = m.reshape(N, K // g) if m is not None else None
    sd = md = None
    sgroup = 0
    if fold_scales and ggml_type in _SCALE_PART_DECODERS and K % QK_K == 0:
        sc8, d, m8, dmin, _ = _SCALE_PART_DECODERS[ggml_type](blocks)

        def rep2(a):  # per-256 d -> K/128 rows
            return a.reshape(N, K // QK_K).repeat_interleave(2, dim=1).T.contiguous()

        s = sc8.reshape(N, K // g)
        m = m8.reshape(N, K // g) if m8 is not None else None
        sd = rep2(d)
        md = rep2(dmin) if dmin is not None else None
        sgroup = QK_K // 2
    s = s.T.contiguous()
    m = m.T.contiguous() if m is not None else None
    ck = nib4c_chunk(K)
    if ggml_type in _NIB4_TYPES and ck is not None:
        return QuantTensor(_pack_nib4c(q.T.to(torch.uint8), ck).contiguous(), s,
                           m, "nib4c", g, (K, N), sd, md, sgroup)
    return QuantTensor(q.T.contiguous(), s, m, "int8", g, (K, N), sd, md, sgroup)


def pad_qt_n(qt: QuantTensor, multiple: int = 2048) -> QuantTensor:
    """Zero-pad the output dim to ``multiple``; ``shape`` keeps the logical
    N and the matmul slices the pad off (zero scales: pad columns are 0)."""
    Np = -(-qt.N // multiple) * multiple
    padn = Np - qt.q.shape[-1]
    if padn == 0:
        return qt

    def pad(a):
        return torch.nn.functional.pad(a, (0, padn)) if a is not None else None

    return QuantTensor(pad(qt.q), pad(qt.s), pad(qt.m), qt.fmt, qt.group,
                       qt.shape, pad(qt.sd), pad(qt.md), qt.sgroup)


def _unpack_nib4c(q: torch.Tensor, K: int) -> torch.Tensor:
    """Packed nib4c (K/2, N) -> int8 values (K, N) in logical row order."""
    p = q.view(torch.uint8) ^ 0x80
    ck = nib4c_chunk(K)
    sh = (K // ck, ck // 2, q.shape[-1])
    return torch.cat([(p & 0x0F).reshape(sh), (p >> 4).reshape(sh)], 1
                     ).reshape(K, -1).to(torch.int8)


def dequantize_qt(qt: QuantTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Materialize the (K, N) weight, pad columns dropped (exact in f32)."""
    s, m = qt.s, qt.m
    if qt.sd is not None:
        rep = qt.sgroup // qt.group
        s = s.float() * qt.sd.repeat_interleave(rep, 0)
        m = m.float() * qt.md.repeat_interleave(rep, 0) if m is not None else None
    vals = _unpack_nib4c(qt.q, qt.K) if qt.fmt == "nib4c" else qt.q
    w = vals.float() * s.repeat_interleave(qt.group, 0)
    if m is not None:
        w = w - m.repeat_interleave(qt.group, 0)
    return w[:, : qt.N].to(dtype)


def dequant_matmul(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """x (..., K) @ qt by dequantize-to-bf16 then ``torch.matmul`` (the port
    of ``quant_matmul_xla``); the M > 8 path."""
    return torch.matmul(x, dequantize_qt(qt, torch.bfloat16).to(x.dtype))


# ---------------------------------------------------------------------------
# K1 / K2: the decode GEMV
# ---------------------------------------------------------------------------


def gemv_plain(x2: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """Plain version of K1/K2: x (M, K) -> f32 (M, N), exact f32 dequant."""
    return x2.float() @ dequantize_qt(qt, torch.float32)


def _gemv_segment(qt: QuantTensor) -> tuple[int, int]:
    """(packed rows per block, nib4c chunk) for the kernel's K split: each
    thread owns seg/32 rows, a multiple of 4 inside one quant group."""
    if qt.fmt == "nib4c":
        ck = nib4c_chunk(qt.K)
        seg = min(512, ck // 2)
    else:
        ck = 0
        seg = next((t for t in (512, 256, 128) if qt.K % t == 0), 0)
    if not seg or qt.group % (seg // 32):
        raise ValueError(f"gemv kernel: unsupported K={qt.K}, group={qt.group}")
    return seg, ck


def _gemv_launch(x2: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    M, K = x2.shape
    Np = qt.q.shape[-1]
    if M > 8 or K != qt.K or Np % 16:
        raise ValueError(f"gemv kernel: M={M}, K={K} vs {qt.shape}, Np={Np}")
    planes = [qt.q, qt.s, qt.m, qt.sd, qt.md]
    if any(t is not None and (t.device != x2.device or not t.is_contiguous()
                              or t.data_ptr() % 16) for t in planes):
        raise ValueError("gemv kernel: planes must be contiguous, 16-byte "
                         "aligned and on x's device")
    seg, ck = _gemv_segment(qt)
    Mp = next(p for p in (1, 2, 4, 8) if p >= M)  # the kernel's row counts
    x = x2.float()
    if Mp != M:
        x = torch.cat([x, x.new_zeros((Mp - M, K))])
    x = x.contiguous()
    out = torch.zeros((Mp, Np), dtype=torch.float32, device=x2.device)
    so = kernels.lib("gemv")
    if so.lcg_gemv.argtypes is None:
        so.lcg_gemv.restype = ctypes.c_int
        so.lcg_gemv.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 7
                                + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    err = so.lcg_gemv(
        int(qt.fmt == "nib4c"), int(qt.sd is not None), Mp, *map(kernels.ptr, (
            x, qt.q, qt.s, qt.m, qt.sd, qt.md, out)),
        K, Np, qt.group, qt.sgroup or 1, ck, seg, kernels.stream(x2.device))
    kernels.check(so, err, f"gemv_{qt.fmt}")
    return out[:M, : qt.N]


@kernels.counted("gemv_int8")
def gemv_int8(x2: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """K1: x (M <= 8, K) @ int8 QuantTensor -> f32 (M, N)."""
    if x2.device.type == "cpu":
        return gemv_plain(x2, qt)
    if qt.fmt != "int8":
        raise ValueError(f"gemv_int8: {qt.fmt} weight")
    out = _gemv_launch(x2, qt)
    gemv_int8.launches += 1
    return out


@kernels.counted("gemv_nib4c")
def gemv_nib4c(x2: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """K2: x (M <= 8, K) @ nib4c QuantTensor -> f32 (M, N)."""
    if x2.device.type == "cpu":
        return gemv_plain(x2, qt)
    if qt.fmt != "nib4c":
        raise ValueError(f"gemv_nib4c: {qt.fmt} weight")
    out = _gemv_launch(x2, qt)
    gemv_nib4c.launches += 1
    return out


# ---------------------------------------------------------------------------
# K5: the prefill-shape dequant matmul (int8 weights, plain scales)
# ---------------------------------------------------------------------------


def qmm_tileable(qt: QuantTensor) -> bool:
    """The JAX package's K5 gate for the int8 format (``_pallas_tileable``
    and no folded scales): the stored N a multiple of 128, and K split into
    512- or 256-row tiles of at least 8 groups, or at most 8192 rows whole."""
    if qt.fmt != "int8" or qt.sd is not None or qt.q.shape[-1] % 128:
        return False
    K = qt.K
    tk = next((t for t in (512, 256) if K % t == 0 and t >= 8 * qt.group), K)
    return tk != K or K <= 8192


def _sub_mins(y: torch.Tensor, xb: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """y - (per-group sums of x) @ m, as the JAX K5 wrapper takes the mins."""
    if qt.m is None:
        return y
    return y - xb.reshape(xb.shape[0], -1, qt.group).sum(-1) @ qt.m.float()


def qmm_plain(x2: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """Plain version of K5: x (M, K) -> f32 (M, N) with the kernel's
    rounding points (x in bf16, each weight the f32 product rounded to
    bf16, f32 sums)."""
    xb = x2.to(torch.bfloat16).float()
    w = (qt.q.float() * qt.s.repeat_interleave(qt.group, 0)).to(torch.bfloat16)
    return _sub_mins(xb @ w.float(), xb, qt)[:, : qt.N]


@kernels.counted("qmm_int8")
def qmm_int8(x2: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """K5: x (M, K) @ int8 plain-scale QuantTensor -> f32 (M, N)."""
    if x2.device.type == "cpu":
        return qmm_plain(x2, qt)
    M, K = x2.shape
    if not qmm_tileable(qt) or K != qt.K or K % 32:
        raise ValueError(f"qmm_int8 kernel: M={M}, K={K}, {qt.fmt} {qt.shape}")
    if any(t.device != x2.device or not t.is_contiguous() or t.data_ptr() % 16
           for t in (qt.q, qt.s)):
        raise ValueError("qmm_int8 kernel: planes must be contiguous, 16-byte "
                         "aligned and on x's device")
    Np = qt.q.shape[-1]
    xb = x2.to(torch.bfloat16).contiguous()
    out = torch.empty((-(-M // 64) * 64, Np), dtype=torch.float32, device=x2.device)
    so = kernels.lib("qmm")
    if so.lcg_qmm_int8.argtypes is None:
        so.lcg_qmm_int8.restype = ctypes.c_int
        so.lcg_qmm_int8.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
    err = so.lcg_qmm_int8(*map(kernels.ptr, (xb, qt.q, qt.s, out)), M, K, Np,
                          qt.group, kernels.stream(x2.device))
    kernels.check(so, err, "qmm_int8")
    qmm_int8.launches += 1
    return _sub_mins(out[:M], xb.float(), qt)[:, : qt.N]


def quant_matmul(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """x (..., K) @ quantized (K, N): the GEMV kernels for M <= 8; for
    M > 8, K5 on the card where its gate holds, else the dequant matmul.
    Returns x.dtype."""
    lead = x.shape[:-1]
    M = int(np.prod(lead)) if lead else 1
    if M > 8:
        if x.is_cuda and qmm_tileable(qt):
            return qmm_int8(x.reshape(M, qt.K), qt).reshape(*lead, qt.N).to(x.dtype)
        return dequant_matmul(x, qt)
    gemv = gemv_nib4c if qt.fmt == "nib4c" else gemv_int8
    return gemv(x.reshape(M, qt.K), qt).reshape(*lead, qt.N).to(x.dtype)


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """Dispatch: dense (K, N) tensor or QuantTensor."""
    if isinstance(w, QuantTensor):
        return quant_matmul(x, w)
    return x @ w
