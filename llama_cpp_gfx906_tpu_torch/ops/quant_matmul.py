"""Quantized weights on the device and the quantized matmul.

Port of ``llama_cpp_gfx906_tpu/ops/quant_matmul.py``.  Device planes are
byte-identical to the JAX package's (so parity compares the same bytes):

- ``int8``  : q int8 (K, N);  w[k, n] = q[k, n] * s[k//g, n] - m[k//g, n]
- ``nib4c`` : q int8 (K/2, N), chunk-local biased 4-bit packing: within each
  CK-row chunk, logical row k pairs with k + CK/2 in one byte stored as
  ``(lo | hi << 4) ^ 0x80``.
- ``nib4``  : q int8 (K/2, N), split-K 4-bit packing of stacked experts whose
  K has no nib4c chunk: byte row r holds logical row r (low nibble) and
  K/2 + r (high nibble), stored ``lo | hi << 4``.

Scales are plain f32 (K/g, N) planes, or folded: int8 sub-scales times f32
super-planes ``sd`` at K/128 rows (each per-256 ``d`` repeated twice), and
likewise for the optional mins.

Compute: a matmul with M <= 8 rows of x goes to the hand-written GEMV
kernels (K1 ``gemv_int8``, K2 ``gemv_nib4c``, ``csrc/gemv.cu``) for every
weight size; the JAX package's ``K*N >= 2**23`` gate is a TPU launch-overhead
heuristic and is not carried over.  M > 8 (prefill) on the card goes to the
tiled dequant matmul K5 (``qmm_int8`` and ``qmm_nib4``, ``csrc/qmm.cu``) for
the weights the JAX package gives its K5 (int8 with plain scales, or split-K
nib4, on its tile grid: :func:`qmm_tileable`); every other weight, and every
M > 8 matmul on the CPU, dequantizes to bf16 and calls ``torch.matmul``, as
the JAX package leaves those to XLA's dequant-dot.  Grid decoding runs in
torch, so it runs on the card when the planes are built there.
"""

from __future__ import annotations

import ctypes
import functools

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


PACKED4 = ("nib4", "nib4c")  # the 4-bit formats: two logical rows per byte


def unpack4(q: torch.Tensor, fmt: str, K: int) -> torch.Tensor:
    """Packed 4-bit planes (..., K/2, N) of format ``fmt`` (nib4c or nib4)
    -> int8 values (..., K, N) in logical row order (JAX ``_unpack4_jnp``)."""
    p = q.view(torch.uint8)
    if fmt == "nib4c":
        p = p ^ 0x80  # undo the bias
    lo, hi = p & 0x0F, p >> 4
    if fmt == "nib4":
        return torch.cat([lo, hi], -2).to(torch.int8)
    ck = nib4c_chunk(K)
    lead = q.shape[:-2]
    sh = (*lead, K // ck, ck // 2, q.shape[-1])
    return torch.cat([lo.reshape(sh), hi.reshape(sh)], -2
                     ).reshape(*lead, K, -1).to(torch.int8)


def values(q: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """The int8 values (..., K, N) of ``qt``'s q plane (or a gather of it)."""
    return unpack4(q, qt.fmt, qt.K) if qt.fmt in PACKED4 else q


def dequantize_qt(qt: QuantTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Materialize the (K, N) weight, pad columns dropped (exact in f32)."""
    s, m = qt.s, qt.m
    if qt.sd is not None:
        rep = qt.sgroup // qt.group
        s = s.float() * qt.sd.repeat_interleave(rep, 0)
        m = m.float() * qt.md.repeat_interleave(rep, 0) if m is not None else None
    vals = values(qt.q, qt)
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
    """(packed rows per block, nib4c chunk) of K6's GEMV units
    (``csrc/gemv_tile.cuh``): each thread owns seg/32 rows inside one quant
    group (an int8 K that is 64 rows past a multiple of 128, such as
    gpt-oss's 2880, takes 64-row segments: 2 rows a thread)."""
    if qt.fmt == "nib4c":
        ck = nib4c_chunk(qt.K)
        seg = min(512, ck // 2)
    else:
        ck = 0
        seg = next((t for t in (512, 256, 128, 64) if qt.K % t == 0), 0)
    if not seg or qt.group % (seg // 32):
        raise ValueError(f"gemv kernel: unsupported K={qt.K}, group={qt.group}")
    return seg, ck


# K1 / K2's schedule (``csrc/gemv.cu``): K walks in stages of GEMV_STAGE
# packed rows; a block takes a tile of 128 or 64 stored columns
# (GEMV_TILES) and the stages of its split; a tile's K splits over up to
# GEMV_MAX_SPLITS blocks (one cluster), merged in split order; inside a
# block GEMV_WARPS warps share the tile, 64 columns and SK / (GEMV_WARPS /
# (tile / 64)) rows of each stage a warp, their sums added in warp order
GEMV_STAGE, GEMV_MAX_SPLITS, GEMV_MAX_M, GEMV_WARPS = 64, 16, 8, 4
GEMV_TILES = (128, 64)
GEMV_GROUPS = (16, 32)  # the scale groups the kernel takes
_GEMV_OUT = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's x and output dtypes


def gemv_config(kp: int, Np: int, sms: int) -> tuple[int, int]:
    """(columns a block, splits) of a K1/K2 launch over ``kp`` packed rows
    and ``Np`` stored columns on a card of ``sms`` multiprocessors: 128-
    column tiles with the fewest splits whose blocks reach every SM (the
    heads' ~1,000-1,600 tiles take one); where even the most splits (the cluster limit, one stage a split) leave SMs idle,
    64-column tiles the same way (a 1024-column projection); else 64
    columns and the most splits.  More splits than reach the SMs cost time:
    past ~200-250 blocks of a cluster's size the launch takes a second wave
    (split sweeps on an H100, ``kernel_times.py --splits``)."""
    stages = kp // GEMV_STAGE
    top = min(GEMV_MAX_SPLITS, stages)
    for tn in GEMV_TILES:
        tiles = -(-Np // tn)
        s = next((s for s in range(1, top + 1) if tiles * s >= sms), None)
        if s is not None:
            return tn, s
    return GEMV_TILES[-1], top


def _gemv_x_parts(x2: torch.Tensor) -> list[torch.Tensor]:
    """The x the kernel's products see, f32: a bf16 x as it is; an f32 x
    as its bf16 high part and the bf16 remainder."""
    if x2.dtype != torch.float32:
        return [x2.float()]
    hi = x2.to(torch.bfloat16).float()
    return [hi, (x2 - hi).to(torch.bfloat16).float()]


def _group_planes(qt: QuantTensor):
    """(scales, mins or None), f32 (K/g, Np): folded planes unfolded with
    the kernel's rounding (int8 sub-scale times f32 super-scale)."""
    s, m = qt.s.float(), None if qt.m is None else qt.m.float()
    if qt.sd is not None:
        rep = qt.sgroup // qt.group
        s = s * qt.sd.repeat_interleave(rep, 0)
        m = m * qt.md.repeat_interleave(rep, 0) if m is not None else None
    return s, m


def gemv_split_plain(x2: torch.Tensor, qt: QuantTensor,
                     out_dtype: torch.dtype = torch.float32, tn: int | None = None,
                     splits: int | None = None, sms: int = 132) -> torch.Tensor:
    """K1/K2's schedule in plain PyTorch (f32): per split (the stages
    ``qmm_split_steps`` deals it) and per warp of the block (``tn`` / 64
    across the columns, the rest across each stage's rows), each quant
    group's integer product with x (an f32 x: its high part and remainder,
    two products) times the group's scale row, minus the group's x sums
    times its min row, summed in K order; the warps' sums added in warp
    order within each split, the splits in split order; cast last.  nib4c:
    a packed row's low nibbles are its chunk's first half, the high ones
    the second.  The kernel's way into bf16 (int8 as two exact parts,
    nibbles biased by 128 and the bias taken off with the mins) changes no
    value: the integers are the same.  ``tn`` and ``splits`` default to
    :func:`gemv_config`'s on a card of ``sms`` multiprocessors."""
    M = x2.shape[0]
    nib = qt.fmt == "nib4c"
    kp, Np = qt.q.shape
    g = qt.group
    auto_tn, auto_splits = gemv_config(kp, Np, sms)
    tn, splits = tn or auto_tn, splits or auto_splits
    kparts = GEMV_WARPS // (tn // 64)
    rows = GEMV_STAGE // kparts
    parts = _gemv_x_parts(x2)
    vals = values(qt.q, qt).float()
    s, m = _group_planes(qt)
    hc = (nib4c_chunk(qt.K) or 0) // 2
    nst = kp // GEMV_STAGE
    y = torch.zeros((M, Np), device=x2.device)
    for rng in qmm_split_steps(nst, splits):
        for kk in range(kparts):
            acc = torch.zeros((M, Np), device=x2.device)
            for st in rng:
                p0 = st * GEMV_STAGE + kk * rows
                k0s = [(p0 // hc) * 2 * hc + p0 % hc] if nib else [p0]
                if nib:
                    k0s.append(k0s[0] + hc)
                for r in range(0, rows, min(rows, g)):  # a scale run, then each K half
                    for k0 in k0s:
                        sl = slice(k0 + r, k0 + r + min(rows, g))
                        w = vals[sl]
                        acc = acc + sum(p[:, sl] @ w for p in parts) * s[(k0 + r) // g]
                        if m is not None:
                            xs = sum(p[:, sl].sum(1) for p in parts)
                            acc = acc - xs[:, None] * m[(k0 + r) // g]
            y = y + acc
    return y[:, : qt.N].to(out_dtype)


def _gemv_launch(x2: torch.Tensor, qt: QuantTensor, out_dtype: torch.dtype = torch.float32,
                 tn: int | None = None, splits: int | None = None) -> torch.Tensor:
    """One K1/K2 launch (``csrc/gemv.cu`` ``lcg_gemv``): (M, N) in
    ``out_dtype`` (f32 or bf16), x read in its own dtype (bf16 or f32; any
    other is cast to f32), the mins taken in the kernel.  ``tn`` and
    ``splits`` (default: :func:`gemv_config`'s) are the block's columns and
    the K split of each column tile."""
    M, K = x2.shape
    kp, Np = qt.q.shape[-2:]
    if (qt.fmt not in ("int8", "nib4c") or not 1 <= M <= GEMV_MAX_M or K != qt.K
            or qt.q.ndim != 2 or Np % 16 or kp % GEMV_STAGE or qt.group not in GEMV_GROUPS
            or out_dtype not in _GEMV_OUT):
        raise ValueError(f"gemv kernel: M={M}, K={K}, {qt.fmt} {qt.shape} stored "
                         f"{tuple(qt.q.shape)} g{qt.group}, out {out_dtype}")
    folded = qt.sd is not None
    sdt = torch.int8 if folded else torch.float32
    planes = [(qt.q, torch.int8), (qt.s, sdt), (qt.m, sdt), (qt.sd, torch.float32),
              (qt.md, torch.float32)]
    if any(t is not None and (t.device != x2.device or not t.is_contiguous()
                              or t.data_ptr() % 16 or t.dtype != dt) for t, dt in planes):
        raise ValueError("gemv kernel: planes must be contiguous, 16-byte aligned, on "
                         "x's device, int8 q and f32 (folded: int8 and f32) scales")
    x = x2 if x2.dtype in _GEMV_OUT else x2.float()
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    auto_tn, auto_splits = gemv_config(kp, Np, _sms(x2.device))
    out = torch.empty((M, qt.N), dtype=out_dtype, device=x2.device)
    so = kernels.lib("gemv")
    if so.lcg_gemv.argtypes is None:
        so.lcg_gemv.restype = ctypes.c_int
        so.lcg_gemv.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 7
                                + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    err = so.lcg_gemv(
        int(qt.fmt == "nib4c"), int(folded), int(x.dtype == torch.float32),
        *map(kernels.ptr, (x, qt.q, qt.s, qt.m, qt.sd, qt.md, out)),
        _GEMV_OUT[out_dtype], M, K, qt.N, Np, qt.group, qt.sgroup,
        nib4c_chunk(K) if qt.fmt == "nib4c" else 0, tn or auto_tn, splits or auto_splits,
        kernels.stream(x2.device))
    kernels.check(so, err, f"gemv_{qt.fmt}")
    return out


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    """The card's multiprocessor count."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@kernels.counted("gemv_int8", lib="gemv", slot=0)
def gemv_int8(x2: torch.Tensor, qt: QuantTensor,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K1: x (M <= 8, K) @ int8 QuantTensor -> (M, N) in ``out_dtype`` (f32
    or bf16); one launch.  On the CPU, :func:`gemv_plain`."""
    if x2.device.type == "cpu":
        return gemv_plain(x2, qt).to(out_dtype)
    if qt.fmt != "int8":
        raise ValueError(f"gemv_int8: {qt.fmt} weight")
    out = _gemv_launch(x2, qt, out_dtype)
    gemv_int8.launches += 1
    return out


@kernels.counted("gemv_nib4c", lib="gemv", slot=1)
def gemv_nib4c(x2: torch.Tensor, qt: QuantTensor,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K2: x (M <= 8, K) @ nib4c QuantTensor -> (M, N) in ``out_dtype`` (f32
    or bf16); one launch.  On the CPU, :func:`gemv_plain`."""
    if x2.device.type == "cpu":
        return gemv_plain(x2, qt).to(out_dtype)
    if qt.fmt != "nib4c":
        raise ValueError(f"gemv_nib4c: {qt.fmt} weight")
    out = _gemv_launch(x2, qt, out_dtype)
    gemv_nib4c.launches += 1
    return out


# ---------------------------------------------------------------------------
# K5: the prefill-shape dequant matmul (int8 or split-K nib4, plain scales)
# ---------------------------------------------------------------------------


def qmm_tileable(qt: QuantTensor) -> bool:
    """The JAX package's K5 gate (``_pallas_tileable`` and no folded scales),
    which K8 shares: an int8 or split-K nib4 weight, the stored N a multiple
    of 128, and K (nib4: each K half) split into 512- or 256-row tiles of
    at least 8 groups, or at most 8192 rows whole.  nib4c is refused, as
    the JAX gate refuses it."""
    if qt.fmt not in ("int8", "nib4") or qt.sd is not None or qt.q.shape[-1] % 128:
        return False
    K = qt.K // 2 if qt.fmt == "nib4" else qt.K
    tk = next((t for t in (512, 256) if K % t == 0 and t >= 8 * qt.group), K)
    return tk != K or K <= 8192


def _sub_mins(y: torch.Tensor, xb: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """y - (per-group sums of x) @ m, as the JAX K5 wrapper takes the mins."""
    if qt.m is None:
        return y
    return y - xb.reshape(xb.shape[0], -1, qt.group).sum(-1) @ qt.m.float()


def qmm_plain(x2: torch.Tensor, qt: QuantTensor,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of K5: x (M, K) -> (M, N) with the kernel's rounding
    points (x in bf16, each weight the f32 product of its value and scale
    rounded to bf16, f32 sums, the mins taken after the product as
    (per-group sums of x) @ m, then ``out_dtype``).  Both formats: int8 and
    split-K nib4."""
    xb = x2.to(torch.bfloat16).float()
    w = (values(qt.q, qt).float() * qt.s.repeat_interleave(qt.group, 0)).to(torch.bfloat16)
    return _sub_mins(xb @ w.float(), xb, qt)[:, : qt.N].to(out_dtype)


qmm_nib4_plain = qmm_plain  # K5-nib4's plain version (JAX _qmm_nib4_kernel's math)

# K5's schedule (``csrc/qmm.cu``): K walks in steps of QMM_STEP packed rows,
# the last QMM_TAIL rows long where the packed K is QMM_TAIL times an odd
# number; output tiles of QMM_BN columns and 64 or 128 rows; a tile's K steps
# split over up to QMM_MAX_SPLITS blocks (one cluster)
QMM_STEP, QMM_TAIL, QMM_BN, QMM_MAX_SPLITS = 64, 32, 128, 8
QMM_GROUPS = (16, 32)  # the scale groups the kernel takes
# a block's fixed cost (prologue, epilogue, the split merge) in K steps, in
# the split chooser's cost of a launch (fitted to split sweeps on an H100)
QMM_BLOCK_STEPS = 4


def qmm_blocks_per_sm(nib: bool, mins: bool) -> int:
    """Blocks an SM holds (csrc/qmm.cu ``__launch_bounds__``): 2 for int8
    without mins, else 1 (registers)."""
    return 1 if nib or mins else 2


def qmm_steps(kp: int) -> list[tuple[int, int]]:
    """(first packed row, rows) of each K step over ``kp`` packed rows."""
    return [(k0, min(QMM_STEP, kp - k0)) for k0 in range(0, kp, QMM_STEP)]


def qmm_split_steps(n: int, splits: int) -> list[range]:
    """The K steps (indices of :func:`qmm_steps`) that each of ``splits``
    blocks of a tile walks, as the kernel deals them: split s takes steps
    [s n / splits, (s + 1) n / splits)."""
    return [range(s * n // splits, (s + 1) * n // splits) for s in range(splits)]


def qmm_config(M: int, kp: int, Np: int, sms: int, nib: bool = False,
               mins: bool = False) -> tuple[int, int]:
    """(rows a block, splits) of a K5 launch: x (M, .) against ``kp`` packed
    rows and ``Np`` stored columns on a card of ``sms`` multiprocessors.
    128-row tiles, or 64 for M <= 64 and where 128-row tiles at the most
    splits would leave SMs idle.  The splits fill the card: at least
    enough blocks for every SM where the steps allow it (``QMM_MAX_SPLITS``
    and one step a split at most), and among those the count whose busiest
    SM has the least work: its waves of resident blocks
    (:func:`qmm_blocks_per_sm`), each costing a block's steps (nib4: two
    products a step) plus ``QMM_BLOCK_STEPS`` for every resident block;
    the fewer splits on a tie."""
    steps = -(-kp // QMM_STEP)
    top = min(QMM_MAX_SPLITS, steps)
    bm = 64 if M <= 64 or -(-M // 128) * (Np // QMM_BN) * top < sms else 128
    tiles = -(-M // bm) * (Np // QMM_BN)
    fill = next((s for s in range(1, top + 1) if tiles * s >= sms), top)
    per_step = 2 if nib else 1
    resident = sms * qmm_blocks_per_sm(nib, mins)

    def cost(s):
        return -(-tiles * s // resident) * (resident // sms) * (
            per_step * -(-steps // s) + QMM_BLOCK_STEPS)

    return bm, min(range(fill, top + 1), key=lambda s: (cost(s), s))


def qmm_split_plain(x2: torch.Tensor, qt: QuantTensor, out_dtype: torch.dtype = torch.float32,
                    splits: int | None = None, sms: int = 132) -> torch.Tensor:
    """K5's schedule in plain PyTorch (f32): per split, its K steps in
    order (:func:`qmm_split_steps`), each step's weight rows dequantized
    with their own scale rows and rounded to bf16, a product and, with
    mins, the x sums of each group of the step times its min row, summed
    apart; the splits' partials added in split order, then the mins' ones;
    the product minus the mins, cast to ``out_dtype``.  ``splits`` defaults
    to :func:`qmm_config`'s on a card of ``sms`` multiprocessors."""
    M = x2.shape[0]
    nib = qt.fmt == "nib4"
    kp, Np = qt.q.shape
    g = qt.group
    if splits is None:
        splits = qmm_config(M, kp, Np, sms, nib, qt.m is not None)[1]
    xb = x2.to(torch.bfloat16).float()
    qb = qt.q.view(torch.uint8).int() if nib else qt.q.int()
    steps = qmm_steps(kp)
    parts, mparts = [], []
    for rng in qmm_split_steps(len(steps), splits):
        acc = torch.zeros((M, Np), device=x2.device)
        accm = torch.zeros((M, Np), device=x2.device)
        for k0, rows in (steps[i] for i in rng):
            for h in range(2 if nib else 1):
                r0 = h * kp + k0  # the logical rows of this half
                v = qb[k0:k0 + rows]
                if nib:
                    v = v >> 4 if h else v & 0x0F
                s = qt.s[r0 // g:(r0 + rows) // g].repeat_interleave(g, 0)
                w = (v.float() * s).to(torch.bfloat16).float()
                xs = xb[:, r0:r0 + rows]
                acc = acc + xs @ w
                if qt.m is not None:
                    accm = accm + xs.reshape(M, rows // g, g).sum(-1) @ \
                        qt.m[r0 // g:(r0 + rows) // g].float()
        parts.append(acc)
        mparts.append(accm)
    y = torch.zeros((M, Np), device=x2.device)
    for p in parts:
        y = y + p
    if qt.m is not None:
        mn = torch.zeros((M, Np), device=x2.device)
        for p in mparts:
            mn = mn + p
        y = y - mn
    return y[:, : qt.N].to(out_dtype)


_QMM_OUT = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's output dtypes


def _qmm_launch(x2: torch.Tensor, qt: QuantTensor, fmt: str, out_dtype: torch.dtype,
                splits: int | None = None, bm: int | None = None) -> torch.Tensor:
    """One K5 launch (``csrc/qmm.cu`` ``lcg_qmm_<fmt>``): (M, N) in
    ``out_dtype`` (f32 or bf16), the mins taken in the kernel.  ``splits``
    and ``bm`` (default: :func:`qmm_config`'s) are the K split of each
    output tile and its rows."""
    M, K = x2.shape
    kp = qt.q.shape[0]
    if (qt.fmt != fmt or not qmm_tileable(qt) or K != qt.K or kp % QMM_TAIL
            or qt.group not in QMM_GROUPS or kp % qt.group):
        raise ValueError(f"qmm_{fmt} kernel: M={M}, K={K}, {qt.fmt} {qt.shape} g{qt.group}")
    if any(t.device != x2.device or not t.is_contiguous() or t.data_ptr() % 16
           or t.ndim != 2 or t.dtype != torch.float32 for t in (qt.s, qt.m) if t is not None) \
            or qt.q.device != x2.device or qt.q.ndim != 2 or not qt.q.is_contiguous() \
            or qt.q.data_ptr() % 16:
        raise ValueError(f"qmm_{fmt} kernel: planes must be 2-D, contiguous, 16-byte "
                         "aligned, f32 scales and mins, on x's device")
    if out_dtype not in _QMM_OUT:
        raise ValueError(f"qmm_{fmt} kernel: output dtype {out_dtype}")
    Np = qt.q.shape[-1]
    auto_bm, auto = qmm_config(M, kp, Np, _sms(x2.device), fmt == "nib4", qt.m is not None)
    xb = x2.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:
        xb = xb.clone()
    out = torch.empty((M, qt.N), dtype=out_dtype, device=x2.device)
    so = kernels.lib("qmm")
    fn = getattr(so, f"lcg_qmm_{fmt}")
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    err = fn(*map(kernels.ptr, (xb, qt.q, qt.s, qt.m, out)), M, K, qt.N, Np, qt.group,
             auto_bm if bm is None else bm,
             auto if splits is None else splits, _QMM_OUT[out_dtype], kernels.stream(x2.device))
    kernels.check(so, err, f"qmm_{fmt}")
    return out


@kernels.counted("qmm_int8", lib="qmm", slot=0)
def qmm_int8(x2: torch.Tensor, qt: QuantTensor,
             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K5: x (M, K) @ int8 plain-scale QuantTensor -> (M, N) in ``out_dtype``
    (f32 or bf16), the mins (if any) taken in the kernel's epilogue; one
    launch.  On the CPU, :func:`qmm_plain`."""
    if x2.device.type == "cpu":
        return qmm_plain(x2, qt, out_dtype)
    out = _qmm_launch(x2, qt, "int8", out_dtype)
    qmm_int8.launches += 1
    return out


@kernels.counted("qmm_nib4", lib="qmm", slot=1)
def qmm_nib4(x2: torch.Tensor, qt: QuantTensor,
             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K5's nib4 mode: x (M, K) @ split-K nib4 QuantTensor -> (M, N) in
    ``out_dtype``: per K half its own x columns and scale rows, two products
    into one f32 sum, then the mins, as the JAX wrapper takes them, in the
    kernel's epilogue; one launch.  On the CPU, :func:`qmm_nib4_plain`."""
    if x2.device.type == "cpu":
        return qmm_nib4_plain(x2, qt, out_dtype)
    out = _qmm_launch(x2, qt, "nib4", out_dtype)
    qmm_nib4.launches += 1
    return out


def quant_matmul(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """x (..., K) @ quantized (K, N): the GEMV kernels for M <= 8 (int8,
    nib4c; one launch, writing x.dtype where that is f32 or bf16); for
    M > 8, K5 on the card where its gate holds (one launch, writing x.dtype
    where that is f32 or bf16), else the dequant matmul (which also takes a
    split-K nib4 weight at M <= 8, as the JAX package leaves it to XLA).
    Returns x.dtype; no rows of x give no rows and no launch."""
    lead = x.shape[:-1]
    M = int(np.prod(lead)) if lead else 1
    if M == 0:
        return x.new_zeros((*lead, qt.N))
    if M > 8 or qt.fmt == "nib4":
        if M > 8 and x.is_cuda and qmm_tileable(qt):
            k5 = qmm_nib4 if qt.fmt == "nib4" else qmm_int8
            dt = x.dtype if x.dtype in _QMM_OUT else torch.float32
            return k5(x.reshape(M, qt.K), qt, dt).reshape(*lead, qt.N).to(x.dtype)
        return dequant_matmul(x, qt)
    gemv = gemv_nib4c if qt.fmt == "nib4c" else gemv_int8
    dt = x.dtype if x.dtype in _GEMV_OUT else torch.float32
    return gemv(x.reshape(M, qt.K), qt, dt).reshape(*lead, qt.N).to(x.dtype)


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """Dispatch: dense (K, N) tensor or QuantTensor."""
    if isinstance(w, QuantTensor):
        return quant_matmul(x, w)
    return x @ w


# ---------------------------------------------------------------------------
# Stacked experts (MoE) and the routed matmul, K8
# ---------------------------------------------------------------------------
# Expert planes carry a leading expert axis: q (E, K, N) int8 or (E, K/2, N)
# nib4c / nib4, s/m (E, K/g, N) f32, never folded; ``shape`` is one expert's
# (K, N).  ``qt.q[e]`` is expert e's slice, at base + e * (its byte stride).


def _expert_grids(raw, ggml_type, shape, device):
    """(q int8 (E, K, N), s, m or None (E, K/g, N), g) of a stacked-expert
    GGUF tensor (E, N, K)."""
    E, N, K = (int(d) for d in shape)
    q, s, m, g = _GRID_DECODERS[ggml_type](
        _as_blocks(raw, GGML_BLOCK_SIZES[ggml_type][1], device))
    q = q.reshape(E, N, K).transpose(1, 2)
    s = s.reshape(E, N, K // g).transpose(1, 2)
    m = m.reshape(E, N, K // g).transpose(1, 2) if m is not None else None
    return q, s, m, g


def _pad_experts(q, s, m, g: int, pad_k: bool, pad_n: bool):
    """Zero-pad K and/or N up to a multiple of 512 (zero scales and mins:
    pad rows and columns dequantize to exact zeros)."""
    K, N = q.shape[-2:]
    pk = -(-K // 512) * 512 - K if pad_k else 0
    pn = -(-N // 512) * 512 - N if pad_n else 0

    def pad(a, rows):
        return None if a is None else torch.nn.functional.pad(a, (0, pn, 0, rows))

    return pad(q, pk), pad(s, pk // g), pad(m, pk // g)


def pack_gguf_experts(raw, ggml_type, shape, pad_k: bool = False,
                      pad_n: bool = False, device="cpu") -> QuantTensor:
    """Decode a stacked-expert GGUF tensor (E, N, K) into a QuantTensor with
    leaves q (E, K, N) int8 or (E, K/2, N) 4-bit and s/m (E, K/g, N) f32
    (JAX ``pack_gguf_experts``, byte-identical planes).

    ``pad_k`` / ``pad_n`` zero-pad that dim up to a multiple of 512, so
    every expert slice factors into K6's chunk grid; the loader pads the
    expert-FF dim only (gate/up ``pad_n``, down ``pad_k``).  A 4-bit type
    packs nib4c where K has a chunk, else split-K ``nib4`` (the first K
    half in the low nibbles, the second in the high ones: K5's and K8's
    nib4 modes read it); other types stay int8."""
    ggml_type = GGMLType(ggml_type)
    q, s, m, g = _expert_grids(raw, ggml_type, shape, device)
    q, s, m = _pad_experts(q, s, m, g, pad_k, pad_n)
    E, K, N = q.shape
    s = s.float().contiguous()
    m = m.float().contiguous() if m is not None else None
    is4 = ggml_type in _NIB4_TYPES and K % (2 * g) == 0
    ck = nib4c_chunk(K) if is4 else None
    if ck is not None and ck % (2 * g) == 0:
        packed = _pack_nib4c(q.reshape(E * K, N).to(torch.uint8), ck)
        return QuantTensor(packed.reshape(E, K // 2, N).contiguous(), s, m,
                           "nib4c", g, (K, N))
    if is4:
        qu = q.to(torch.uint8)
        packed = (qu[:, : K // 2] | (qu[:, K // 2:] << 4)).view(torch.int8)
        return QuantTensor(packed.contiguous(), s, m, "nib4", g, (K, N))
    return QuantTensor(q.contiguous(), s, m, "int8", g, (K, N))


def pack_experts_int8_g16(raw, ggml_type, shape, pad_k: bool = False,
                          pad_n: bool = False, device="cpu") -> QuantTensor:
    """Stacked experts as int8 values with group-16 scales and mins (zero
    mins where the type has none): the layout that unifies expert tensors
    of mixed types across layers (JAX ``pack_experts_int8_g16``)."""
    q, s, m, g = _expert_grids(raw, GGMLType(ggml_type), shape, device)
    if m is None:
        m = torch.zeros_like(s)
    if g != 16:
        s, m = s.repeat_interleave(g // 16, 1), m.repeat_interleave(g // 16, 1)
    q, s, m = _pad_experts(q, s, m, 16, pad_k, pad_n)
    return QuantTensor(q.contiguous(), s.float().contiguous(),
                       m.float().contiguous(), "int8", 16, tuple(q.shape[1:]))


def qt_expert(qt: QuantTensor, e: int) -> QuantTensor:
    """Expert e of a stacked QuantTensor (views of its planes, any format)."""
    take = (lambda a: None if a is None else a[e])  # noqa: E731
    return QuantTensor(take(qt.q), take(qt.s), take(qt.m), qt.fmt, qt.group,
                       qt.shape, take(qt.sd), take(qt.md), qt.sgroup)


def _expert_weights(q, s, m, qt: QuantTensor) -> torch.Tensor:
    """Gathered expert planes (..., K[/2], N) of any format -> f32 weights
    (..., K, N)."""
    w = values(q, qt).float() * s.float().repeat_interleave(qt.group, -2)
    if m is not None:
        w = w - m.float().repeat_interleave(qt.group, -2)
    return w


def dequantize_qt_experts(qt: QuantTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Every expert's (K, N) weight, (E, K, N) (exact in f32)."""
    if qt.sd is not None:
        raise ValueError("stacked experts are never folded")
    return _expert_weights(qt.q, qt.s, qt.m, qt).to(dtype)


@kernels.counted("routed_gather")
def routed_quant_matmul_plain(x: torch.Tensor, qt: QuantTensor,
                              idx: torch.Tensor) -> torch.Tensor:
    """out[p] = x[p] @ dequant(experts[idx[p]]) (JAX
    ``routed_quant_matmul_xla``): the quantized slices are gathered, then
    dequantized per pair in f32; returns x.dtype.  The card runs it for
    nib4c experts, as the JAX package runs its XLA gather there (no Pallas
    kernel takes them); those calls count as ``routed_gather``."""
    if qt.sd is not None:
        raise ValueError("stacked experts are never folded")
    w = _expert_weights(qt.q[idx], qt.s[idx],
                        qt.m[idx] if qt.m is not None else None, qt)
    out = torch.einsum("pk,pkn->pn", x.float(), w)
    if x.is_cuda:
        routed_quant_matmul_plain.launches += 1
    return out.to(x.dtype)


def _rqmm_launch(x: torch.Tensor, qt: QuantTensor, idx: torch.Tensor,
                 fmt: str) -> torch.Tensor:
    """One K8 launch (``csrc/rqmm.cu`` ``lcg_rqmm_<fmt>``); f32 (P, N)."""
    P, K = x.shape
    E, _, Np = qt.q.shape
    step = 64 if fmt == "nib4" else 16
    if qt.fmt != fmt or not qmm_tileable(qt) or K != qt.K or K % step:
        raise ValueError(f"rqmm_{fmt} kernel: P={P}, K={K}, {qt.fmt} {qt.shape}")
    planes = [t for t in (qt.q, qt.s, qt.m) if t is not None]
    if any(t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16
           for t in planes) or qt.s.dtype != torch.float32:
        raise ValueError(f"rqmm_{fmt} kernel: planes must be contiguous, 16-byte "
                         "aligned, f32 scales, on x's device")
    if idx.dtype != torch.int32 or idx.device != x.device or idx.shape != (P,):
        raise ValueError(f"rqmm_{fmt} kernel: idx must be (P,) int32 on x's device")
    xb = x.to(torch.bfloat16).contiguous()
    so = kernels.lib("rqmm")
    fn = getattr(so, f"lcg_rqmm_{fmt}")
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    if so.lcg_rqmm_splits.argtypes is None:
        so.lcg_rqmm_splits.restype = ctypes.c_int
        so.lcg_rqmm_splits.argtypes = [ctypes.c_int] * 4
    # the split runs over packed rows (nib4: K/2, each carrying both halves)
    splits = so.lcg_rqmm_splits(P, qt.q.shape[1], Np, _sms(x.device))
    # each split's partial sums (scratch) and one arrival counter per (pair,
    # 128-column tile): the kernel adds the splits in order
    out = torch.empty((P, Np), dtype=torch.float32, device=x.device)
    part = torch.empty(splits * P * Np if splits > 1 else 1, dtype=torch.float32,
                       device=x.device)
    cnt = kernels.tile_counters(x.device, P * (Np // 128))
    err = fn(*map(kernels.ptr, (xb, qt.q, qt.s, qt.m, idx.contiguous(), out, part, cnt)),
             P, K, Np, qt.group, E, splits, kernels.stream(x.device))
    kernels.check(so, err, f"rqmm_{fmt}")
    return out[:, : qt.N]


@kernels.counted("rqmm_int8", lib="rqmm", slot=0)
def rqmm_int8(x: torch.Tensor, qt: QuantTensor, idx: torch.Tensor) -> torch.Tensor:
    """K8: out[p] = x[p] @ experts[idx[p]] for int8 experts with plain
    scales, f32 (P, N): x rounded to bf16, each weight ``bf16(q*s - m)``,
    f32 sums.  ``idx`` (P,) int32 stays on the device (the kernel reads it
    there, so a captured graph replays with new ids).  On the CPU, the
    plain version of the same rounding points (:func:`rqmm_plain`)."""
    if x.device.type == "cpu":
        return rqmm_plain(x, qt, idx)
    out = _rqmm_launch(x, qt, idx, "int8")
    rqmm_int8.launches += 1
    return out


@kernels.counted("rqmm_nib4", lib="rqmm", slot=1)
def rqmm_nib4(x: torch.Tensor, qt: QuantTensor, idx: torch.Tensor) -> torch.Tensor:
    """K8's nib4 mode: out[p] = x[p] @ experts[idx[p]] for split-K nib4
    experts, f32 (P, N): per K half, x rounded to bf16 and each weight
    ``bf16(nibble*s - m)`` with that half's scales and mins, both halves
    summed into one f32 total.  On the CPU, :func:`rqmm_nib4_plain`."""
    if x.device.type == "cpu":
        return rqmm_nib4_plain(x, qt, idx)
    out = _rqmm_launch(x, qt, idx, "nib4")
    rqmm_nib4.launches += 1
    return out


def rqmm_plain(x: torch.Tensor, qt: QuantTensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K8 with its rounding points, f32 (P, N): the mins
    folded into each weight before its bf16 rounding (int8 and nib4)."""
    w = _expert_weights(qt.q[idx.long()], qt.s[idx.long()],
                        qt.m[idx.long()] if qt.m is not None else None, qt)
    xb = x.to(torch.bfloat16).float()
    return torch.einsum("pk,pkn->pn", xb, w.to(torch.bfloat16).float())[:, : qt.N]


rqmm_nib4_plain = rqmm_plain  # K8-nib4's plain version (JAX _rqmm_nib4_kernel's math)


def routed_quant_matmul(x: torch.Tensor, qt: QuantTensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """out[p] = x[p] @ experts[idx[p]] with the experts kept quantized
    (JAX ``routed_quant_matmul``): K8 on the card where its gate holds
    (int8 or split-K nib4 experts), the quantized gather
    (:func:`routed_quant_matmul_plain`) elsewhere.  K8's gate is the JAX
    package's, ``_pallas_tileable`` and no folded scales: K5's
    (:func:`qmm_tileable`); it refuses nib4c experts, as the JAX kernel
    does.  Returns x.dtype."""
    if x.is_cuda and qmm_tileable(qt):
        k8 = rqmm_nib4 if qt.fmt == "nib4" else rqmm_int8
        return k8(x, qt, idx.to(torch.int32)).to(x.dtype)
    return routed_quant_matmul_plain(x, qt, idx)
