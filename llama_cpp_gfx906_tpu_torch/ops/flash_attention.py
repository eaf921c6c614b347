"""K4: causal GQA prefill flash attention.

Port of ``llama_cpp_gfx906_tpu/ops/flash_attention.py::flash_attention`` for
a bf16, f32 or int8 cache (int8 with ``k_scales``/``v_scales`` (B, S, Hkv)
f32, the JAX wrapper's arguments), with GQA, the ``n_past`` offset, sliding
window, softcap and sinks.  The kernel (``csrc/flash_attention.cu``) reads K
and V from the stored (B, S, Hkv, D) layout (no (B, H, S, D) transpose copy)
and skips key tiles that are wholly masked.  It has two bodies: a bf16 q
runs the tensor-core body (``mma.sync``, bf16 operands, f32 sums; an int8
cache is widened to bf16 in shared memory and its scales go on the scores
and on p, as the JAX kernel does), counted also as the mode ``mma``; an f32
q runs the FMA body (full f32 products; int8 rows dequantized to f32).  See
the source for the design and the bound.

In the int8 mode the JAX kernel returns bf16; this one returns q's dtype,
rounded once from the f32 accumulator.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels


def flash_attention_plain(q, k_cache, v_cache, n_past, scale: float,
                          sliding_window: int = 0, logit_softcap: float = 0.0,
                          sinks=None, k_scales=None, v_scales=None) -> torch.Tensor:
    """Plain version of K4: the masked-softmax einsum, over rows
    dequantized to f32 in the int8 mode."""
    from .attention import attend

    if k_scales is not None:
        k_cache = k_cache.float() * k_scales.reshape(*k_cache.shape[:3], 1)
        v_cache = v_cache.float() * v_scales.reshape(*v_cache.shape[:3], 1)
    return attend(q, k_cache, v_cache, n_past, scale, sliding_window,
                  logit_softcap, sinks)


@kernels.counted("flash_attention", lib="flash_attention", modes=("int8", "mma"))
def flash_attention(q, k_cache, v_cache, n_past, scale: float,
                    sliding_window: int = 0, logit_softcap: float = 0.0,
                    sinks=None, k_scales=None, v_scales=None) -> torch.Tensor:
    """Attention of q (B, T, Hq, D) over the cache (B, S, Hkv, D), which
    already holds the T new rows at n_past; returns (B, T, Hq, D) in q's
    dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k_cache, v_cache, n_past, scale,
                                     sliding_window, logit_softcap, sinks,
                                     k_scales, v_scales)
    B, T, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    quant = k_scales is not None
    dt = q.dtype if quant else k_cache.dtype
    if D not in (64, 128, 256):
        raise ValueError(f"flash_attention: head dim {D} (64, 128 or 256)")
    want = torch.int8 if quant else dt
    if dt not in (torch.bfloat16, torch.float32) or k_cache.dtype != want or \
            v_cache.dtype != want:
        raise ValueError(f"flash_attention: unsupported cache dtype {k_cache.dtype}"
                         f" for q of dtype {q.dtype}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("flash_attention: the cache must be contiguous")
    ks = vs = None
    if quant:
        ks, vs = k_scales.float().contiguous(), v_scales.float().contiguous()
        if ks.numel() != B * S * Hkv or vs.numel() != ks.numel():
            raise ValueError("flash_attention: scales must be (B, S, Hkv)")
    qc = q.to(dt).contiguous()
    if dt == torch.bfloat16 and any(t.data_ptr() % 16 for t in (qc, k_cache, v_cache)):
        raise ValueError("flash_attention: q and the cache must start 16-byte aligned")
    out = torch.empty((B, T, Hq, D), dtype=dt, device=q.device)
    npast = n_past.to(device=q.device, dtype=torch.int32).contiguous()
    sk = sinks.float().contiguous() if sinks is not None else None
    so = kernels.lib("flash_attention")
    if so.lcg_flash_attention.argtypes is None:
        so.lcg_flash_attention.restype = ctypes.c_int
        so.lcg_flash_attention.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    err = so.lcg_flash_attention(
        int(dt == torch.bfloat16), int(quant), D,
        *map(kernels.ptr, (qc, k_cache, v_cache, ks, vs, npast, sk, out)),
        B, T, S, Hq, Hkv, float(scale), int(sliding_window),
        float(logit_softcap), kernels.stream(q.device))
    kernels.check(so, err, "flash_attention")
    kernels.count(flash_attention, quant, dt == torch.bfloat16)
    return out.to(q.dtype)
