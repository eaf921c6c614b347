"""K4: causal GQA prefill flash attention.

Port of ``llama_cpp_gfx906_tpu/ops/flash_attention.py::flash_attention`` for
a bf16 or f32 cache, with GQA, the ``n_past`` offset, sliding window, softcap
and sinks.  The kernel (``csrc/flash_attention.cu``) tiles (query tile,
query head, batch), reads K and V strided from the stored (B, S, Hkv, D)
layout (no (B, H, S, D) transpose copy) and skips key tiles that are wholly
masked; see the source for its design and bound.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels


def flash_attention_plain(q, k_cache, v_cache, n_past, scale: float,
                          sliding_window: int = 0, logit_softcap: float = 0.0,
                          sinks=None) -> torch.Tensor:
    """Plain version of K4: the masked-softmax einsum."""
    from .attention import attend

    return attend(q, k_cache, v_cache, n_past, scale, sliding_window,
                  logit_softcap, sinks)


@kernels.counted("flash_attention")
def flash_attention(q, k_cache, v_cache, n_past, scale: float,
                    sliding_window: int = 0, logit_softcap: float = 0.0,
                    sinks=None) -> torch.Tensor:
    """Attention of q (B, T, Hq, D) over the cache (B, S, Hkv, D), which
    already holds the T new rows at n_past; returns (B, T, Hq, D) in q's
    dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k_cache, v_cache, n_past, scale,
                                     sliding_window, logit_softcap, sinks)
    B, T, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    dt = k_cache.dtype
    if D not in (64, 128, 256):
        raise ValueError(f"flash_attention: head dim {D} (64, 128 or 256)")
    if dt not in (torch.bfloat16, torch.float32) or v_cache.dtype != dt:
        raise ValueError(f"flash_attention: unsupported cache dtype {dt}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("flash_attention: the cache must be contiguous")
    qc = q.to(dt).contiguous()
    out = torch.empty((B, T, Hq, D), dtype=dt, device=q.device)
    npast = n_past.to(device=q.device, dtype=torch.int32).contiguous()
    sk = sinks.float().contiguous() if sinks is not None else None
    so = kernels.lib("flash_attention")
    if so.lcg_flash_attention.argtypes is None:
        so.lcg_flash_attention.restype = ctypes.c_int
        so.lcg_flash_attention.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    err = so.lcg_flash_attention(
        int(dt == torch.bfloat16), D,
        *map(kernels.ptr, (qc, k_cache, v_cache, npast, sk, out)),
        B, T, S, Hq, Hkv, float(scale), int(sliding_window),
        float(logit_softcap), kernels.stream(q.device))
    kernels.check(so, err, "flash_attention")
    flash_attention.launches += 1
    return out.to(q.dtype)
