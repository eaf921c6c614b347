"""K3: decode attention for a few new queries per KV head.

Port of ``llama_cpp_gfx906_tpu/ops/flash_decode.py::flash_decode`` for a
bf16 or f32 cache, with GQA, the ``n_past`` offset, sliding window, softcap
and sinks.  The kernel (``csrc/flash_decode.cu``) runs one block per (batch,
KV head), walks only the live cache rows and reads them in their stored
(B, S, Hkv, D) layout; see the source for its design and bound.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

MAX_QUERIES = 128  # G*T queries per KV head the kernel takes


def flash_decode_plain(q, k_cache, v_cache, n_past, scale: float,
                       sliding_window: int = 0, logit_softcap: float = 0.0,
                       sinks=None) -> torch.Tensor:
    """Plain version of K3: the masked-softmax einsum."""
    from .attention import attend

    return attend(q, k_cache, v_cache, n_past, scale, sliding_window,
                  logit_softcap, sinks)


@kernels.counted("flash_decode")
def flash_decode(q, k_cache, v_cache, n_past, scale: float,
                 sliding_window: int = 0, logit_softcap: float = 0.0,
                 sinks=None) -> torch.Tensor:
    """Attention of q (B, T, Hq, D) over the cache (B, S, Hkv, D), which
    already holds the T new rows at n_past; returns (B, T, Hq, D) in q's
    dtype."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, n_past, scale,
                                  sliding_window, logit_softcap, sinks)
    B, T, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    NQ = G * T
    if NQ > MAX_QUERIES or D not in (64, 128, 256) or (
            D == 256 and k_cache.dtype != torch.bfloat16):
        raise ValueError(f"flash_decode: G*T = {NQ} (at most {MAX_QUERIES}), "
                         f"head dim {D} (64, 128, or 256 with a bf16 cache)")
    if k_cache.dtype not in (torch.bfloat16, torch.float32) or \
            v_cache.dtype != k_cache.dtype:
        raise ValueError(f"flash_decode: unsupported cache dtype {k_cache.dtype}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("flash_decode: the cache must be contiguous")
    # lane u = g*T + t of KV head h is query head h*G + g at new token t
    qh = q.float().permute(0, 2, 1, 3).reshape(B, Hkv, NQ, D).contiguous()
    sinks_l = None
    if sinks is not None:
        lane_head = torch.arange(Hkv * NQ, device=q.device)
        lane_head = lane_head // NQ * G + (lane_head % NQ) // T
        sinks_l = sinks.float()[lane_head].contiguous()
    out = torch.empty((B, Hkv, NQ, D), dtype=torch.float32, device=q.device)
    npast = n_past.to(device=q.device, dtype=torch.int32).contiguous()
    so = kernels.lib("flash_decode")
    if so.lcg_flash_decode.argtypes is None:
        so.lcg_flash_decode.restype = ctypes.c_int
        so.lcg_flash_decode.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    err = so.lcg_flash_decode(
        int(k_cache.dtype == torch.bfloat16), D,
        *map(kernels.ptr, (qh, k_cache, v_cache, npast, sinks_l, out)),
        B, S, Hkv, NQ, T, float(scale), int(sliding_window),
        float(logit_softcap), kernels.stream(q.device))
    kernels.check(so, err, "flash_decode")
    flash_decode.launches += 1
    out = out.reshape(B, Hkv, G, T, D).permute(0, 3, 1, 2, 4)
    return out.reshape(B, T, Hq, D).to(q.dtype)
