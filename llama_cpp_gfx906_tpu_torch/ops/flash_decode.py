"""K3: decode attention for a few new queries per KV head.

Port of ``llama_cpp_gfx906_tpu/ops/flash_decode.py::flash_decode`` for a
bf16, f32 or q8 (``QuantKV``: int8 rows and per-row scales) cache, with GQA,
the ``n_past`` offset, sliding window, softcap, sinks, a batch-shared
prefix segment ``shared_k``/``shared_v`` (1, S0, Hkv, D) in the compute
dtype, walked before each sequence's own rows, ALiBi slopes (Hq,) and
self-extend logical positions ``kv_pos`` (B, S) / ``q_pos`` (B, T) (not
with a shared segment, as in JAX).  The kernel
(``csrc/flash_decode.cu``) runs one block per (batch, KV head), walks only
the live cache rows and reads them in their stored (B, S, Hkv, D) layout,
dequantizing int8 rows in the kernel; see the source for its design and
bound.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .kv_quant import QuantKV, dequantize_rows

MAX_QUERIES = 128  # G*T queries per KV head the kernel takes
_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def flash_decode_plain(q, k_cache, v_cache, n_past, scale: float,
                       sliding_window: int = 0, logit_softcap: float = 0.0,
                       sinks=None, shared_k=None, shared_v=None, alibi_slopes=None,
                       kv_pos=None, q_pos=None) -> torch.Tensor:
    """Plain version of K3: the masked-softmax einsum, over rows
    dequantized to f32 for a q8 cache."""
    from .attention import attend

    if isinstance(k_cache, QuantKV):
        k_cache = dequantize_rows(k_cache, torch.float32)
        v_cache = dequantize_rows(v_cache, torch.float32)
    return attend(q, k_cache, v_cache, n_past, scale, sliding_window,
                  logit_softcap, sinks, kv_pos=kv_pos, q_pos=q_pos,
                  alibi_slopes=alibi_slopes, shared_k=shared_k, shared_v=shared_v)


@kernels.counted("flash_decode", lib="flash_decode",
                 modes=("int8", "shared", "alibi", "pos"))
def flash_decode(q, k_cache, v_cache, n_past, scale: float,
                 sliding_window: int = 0, logit_softcap: float = 0.0,
                 sinks=None, shared_k=None, shared_v=None, alibi_slopes=None,
                 kv_pos=None, q_pos=None) -> torch.Tensor:
    """Attention of q (B, T, Hq, D) over the cache (B, S, Hkv, D) or a
    ``QuantKV`` of that shape, which already holds the T new rows at n_past,
    after the shared rows (1, S0, Hkv, D) when given; returns (B, T, Hq, D)
    in q's dtype.  ``alibi_slopes`` (Hq,) bias the scores by distance;
    ``kv_pos`` (B, S) and ``q_pos`` (B, T) are the rows' and the queries'
    logical positions (self-extend)."""
    if (kv_pos is None) != (q_pos is None):
        raise ValueError("flash_decode: kv_pos and q_pos go together")
    if kv_pos is not None and shared_k is not None:
        raise NotImplementedError("shared-prefix KV + self-extend positions")
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, n_past, scale,
                                  sliding_window, logit_softcap, sinks,
                                  shared_k, shared_v, alibi_slopes, kv_pos, q_pos)
    quant = isinstance(k_cache, QuantKV)
    if quant != isinstance(v_cache, QuantKV):
        raise ValueError("flash_decode: K and V caches of different kinds")
    kq, vq = (k_cache.q, v_cache.q) if quant else (k_cache, v_cache)
    B, T, Hq, D = q.shape
    S, Hkv = kq.shape[1], kq.shape[2]
    G = Hq // Hkv
    NQ = G * T
    if kq.dtype not in _KIND or vq.dtype != kq.dtype:
        raise ValueError(f"flash_decode: unsupported cache dtype {kq.dtype}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("flash_decode: the cache must be contiguous")
    # without shared rows the int8 kernel takes the bf16 instantiation (the
    # smaller shared-memory stage)
    S0, sh_kind, shk, shv = 0, 1 if quant else _KIND[kq.dtype], None, None
    if shared_k is not None:
        S0 = shared_k.shape[1]
        shk, shv = shared_k.contiguous(), shared_v.contiguous()
        if shk.shape != (1, S0, Hkv, D) or shv.shape != shk.shape:
            raise ValueError(f"flash_decode: shared rows {tuple(shk.shape)}, "
                             f"want (1, S0, {Hkv}, {D})")
        sh_kind = _KIND.get(shk.dtype, -1)
        if shv.dtype != shk.dtype or sh_kind not in (0, 1) or (
                not quant and shk.dtype != kq.dtype):
            raise ValueError(f"flash_decode: shared rows of dtype {shk.dtype} "
                             f"beside a {kq.dtype} cache")
    f32_tile = torch.float32 in (kq.dtype, shk.dtype if S0 else kq.dtype)
    if NQ > MAX_QUERIES or D not in (64, 128, 256) or (D == 256 and f32_tile):
        raise ValueError(f"flash_decode: G*T = {NQ} (at most {MAX_QUERIES}), "
                         f"head dim {D} (64, 128, or 256 without f32 rows)")
    # lane u = g*T + t of KV head h is query head h*G + g at new token t
    qh = q.float().permute(0, 2, 1, 3).reshape(B, Hkv, NQ, D).contiguous()
    # per lane (Hkv, NQ): the sink logit and the ALiBi slope of its head
    sinks_l = slopes_l = None
    if sinks is not None or alibi_slopes is not None:
        lane_head = torch.arange(Hkv * NQ, device=q.device)
        lane_head = lane_head // NQ * G + (lane_head % NQ) // T
        if sinks is not None:
            sinks_l = sinks.float()[lane_head].contiguous()
        if alibi_slopes is not None:
            slopes_l = alibi_slopes.float()[lane_head].contiguous()
    kvp = qp = None
    if kv_pos is not None:
        kvp = kv_pos.to(device=q.device, dtype=torch.int32).contiguous()
        qp = q_pos.to(device=q.device, dtype=torch.int32).contiguous()
        if kvp.shape != (B, S) or qp.shape != (B, T):
            raise ValueError(f"flash_decode: positions {tuple(kvp.shape)} / "
                             f"{tuple(qp.shape)}, want ({B}, {S}) / ({B}, {T})")
    out = torch.empty((B, Hkv, NQ, D), dtype=torch.float32, device=q.device)
    npast = n_past.to(device=q.device, dtype=torch.int32).contiguous()
    ks = vs = None
    if quant:
        ks, vs = k_cache.s, v_cache.s  # (B, S, Hkv, 1) f32: row-major (B, S, Hkv)
    so = kernels.lib("flash_decode")
    if so.lcg_flash_decode.argtypes is None:
        so.lcg_flash_decode.restype = ctypes.c_int
        so.lcg_flash_decode.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 7 + [ctypes.c_int]
            + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    err = so.lcg_flash_decode(
        _KIND[kq.dtype], sh_kind, D,
        *map(kernels.ptr, (qh, kq, vq, ks, vs, shk, shv)), S0,
        *map(kernels.ptr, (npast, sinks_l, slopes_l, kvp, qp, out)),
        B, S, Hkv, NQ, T, float(scale), int(sliding_window),
        float(logit_softcap), kernels.stream(q.device))
    kernels.check(so, err, "flash_decode")
    kernels.count(flash_decode, quant, S0 > 0, alibi_slopes is not None,
                  kv_pos is not None)
    out = out.reshape(B, Hkv, G, T, D).permute(0, 3, 1, 2, 4)
    return out.reshape(B, T, Hq, D).to(q.dtype)
