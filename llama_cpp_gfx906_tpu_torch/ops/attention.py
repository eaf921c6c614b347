"""Attention over an in-place KV cache (port of
``llama_cpp_gfx906_tpu/ops/attention.py``).

Shapes:
  q:          (B, T, Hq, Dh)   new queries
  k/v new:    (B, T, Hkv, Dh)
  k/v cache:  (B, S, Hkv, Dh)  updated in place (the JAX package donates it),
              or a ``QuantKV`` (q8: int8 rows + per-row f32 scales)
  n_past:     (B,) int32       rows already in the cache, on q's device
  shared k/v: (1, S0, Hkv, Dh) a batch-shared prefix segment at logical
              positions 0..S0-1; the own rows then sit at S0 + row

:func:`attend` is the plain masked-softmax einsum: the oracle of the K3 and
K4 kernels and the CPU path.  On the card :func:`mha_with_cache` sends a
call to K3 ``flash_decode`` when the G*T queries of a KV head fit its
128-query limit (every cache kind, with or without a shared segment, ALiBi
slopes or self-extend positions), else to K4 ``flash_attention`` (bf16/f32
or int8 cache).  A chunk of more than 128 queries per KV head with a shared
segment, ALiBi or logical positions has no kernel, in the JAX package
either (its flash prefill has none of those modes and leaves them to XLA):
it takes the einsum on the card, counted by :func:`attend_einsum`.
(The JAX package's ``S >= 4096`` condition for its decode kernel is about
the TPU einsum reading the whole allocation; it is not carried over.)
"""

from __future__ import annotations

import math

import torch

from .. import kernels
from .flash_attention import flash_attention
from .flash_decode import MAX_QUERIES, flash_decode
from .kv_quant import QuantKV, dequantize_rows, insert_quant

NEG_INF = -1e30


def alibi_slopes_for(n_heads: int) -> torch.Tensor:
    """Per-head ALiBi slopes (JAX ``alibi_slopes_for``, HF
    ``build_alibi_tensor``): the geometric ladder of the nearest power of two
    n below ``n_heads``, then every other rung of the 2n ladder for the
    rest."""
    n = 2 ** math.floor(math.log2(n_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
    slopes = [base ** (i + 1) for i in range(n)]
    if n < n_heads:
        extra = 2.0 ** (-(2.0 ** -(math.log2(2 * n) - 3)))
        slopes += [extra ** (2 * i + 1) for i in range(n_heads - n)]
    return torch.tensor(slopes, dtype=torch.float32)


_SLOPES: dict = {}


def alibi_slopes_on(n_heads: int, device) -> torch.Tensor:
    """:func:`alibi_slopes_for` on ``device``, copied there once (a step that
    reads them can be captured in a CUDA graph)."""
    key = (n_heads, torch.device(device))
    if key not in _SLOPES:
        _SLOPES[key] = alibi_slopes_for(n_heads).to(device)
    return _SLOPES[key]


def insert_kv(cache: torch.Tensor, new: torch.Tensor, n_past: torch.Tensor) -> None:
    """Write the new K or V rows at each sequence's offset, in place."""
    B, T = new.shape[:2]
    rows = n_past.long()[:, None] + torch.arange(T, device=new.device)[None, :]
    cache[torch.arange(B, device=new.device)[:, None], rows] = new.to(cache.dtype)


def attention_logits(q, k_cache, n_past, scale: float, sliding_window: int = 0,
                     logit_softcap: float = 0.0, kv_pos=None, q_pos=None,
                     alibi_slopes=None, shared_k=None):
    """:func:`attend`'s scores before the mask, in f32: (B, Hkv, G, T, S0 + S)
    over the shared rows then the cache's, softcapped and ALiBi-biased; and
    the mask (B, T, S0 + S) of the keys each new query sees."""
    B, T, Hq, Dh = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    dev = q.device
    qg = q.float().reshape(B, T, Hkv, G, Dh)
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k_cache.float())
    n_shared = 0
    if shared_k is not None:
        n_shared = shared_k.shape[1]
        sh = torch.einsum("bthgd,shd->bhgts", qg, shared_k[0].float())
        scores = torch.cat([sh, scores], -1)
    scores = scores * scale
    if logit_softcap > 0.0:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    n_past = n_past.to(dev).long()
    if kv_pos is not None:
        qp, sp = q_pos.to(dev).long(), kv_pos.to(dev).long()
        mask = sp[:, None, :] <= qp[:, :, None]
        live = torch.arange(S, device=dev)[None, :] < (n_past[:, None] + T)
        mask &= live[:, None, :]
        if sliding_window > 0:
            mask &= sp[:, None, :] > qp[:, :, None] - sliding_window
        dist = (qp[:, :, None] - sp[:, None, :]).float()
    else:
        qp = n_shared + n_past[:, None] + torch.arange(T, device=dev)[None, :]
        sp = torch.arange(n_shared + S, device=dev)[None, :]
        mask = sp[:, None, :] <= qp[:, :, None]
        if sliding_window > 0:
            mask &= sp[:, None, :] > qp[:, :, None] - sliding_window
        dist = (qp[:, :, None] - sp[:, None, :]).float()
    if alibi_slopes is not None:
        sl = alibi_slopes.to(dev).float().reshape(Hkv, G)
        scores = scores - sl[None, :, :, None, None] * dist[:, None, None]
    return scores, mask


def attend(q, k_cache, v_cache, n_past, scale: float, sliding_window: int = 0,
           logit_softcap: float = 0.0, sinks=None, kv_pos=None, q_pos=None,
           alibi_slopes=None, shared_k=None, shared_v=None) -> torch.Tensor:
    """Masked-softmax attention of the T new queries over the cache, in f32;
    returns (B, T, Hq, Dh) in q's dtype.  ``kv_pos``/``q_pos`` (self-extend
    logical positions), ``alibi_slopes`` and the batch-shared prefix rows
    ``shared_k``/``shared_v`` (1, S0, Hkv, Dh) follow the JAX einsum path."""
    B, T, Hq, Dh = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    dev = q.device
    n_shared = shared_k.shape[1] if shared_k is not None else 0
    scores, mask = attention_logits(q, k_cache, n_past, scale, sliding_window,
                                    logit_softcap, kv_pos, q_pos, alibi_slopes, shared_k)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    if sinks is not None:
        sk = sinks.to(dev).float().reshape(Hkv, G)[None, :, :, None]
        m = torch.maximum(scores.amax(-1), sk)
        e = torch.exp(scores - m[..., None])
        probs = e / (e.sum(-1) + torch.exp(sk - m))[..., None]
    else:
        probs = torch.softmax(scores, -1)
    out = torch.einsum("bhgts,bshd->bthgd", probs[..., n_shared:], v_cache.float())
    if shared_v is not None:
        out = out + torch.einsum("bhgts,shd->bthgd", probs[..., :n_shared],
                                 shared_v[0].float())
    return out.reshape(B, T, Hq, Dh).to(q.dtype)


@kernels.counted("attend_einsum")
def attend_einsum(q, k_cache, v_cache, n_past, scale: float,
                  sliding_window: int = 0, logit_softcap: float = 0.0,
                  sinks=None, shared_k=None, shared_v=None, alibi_slopes=None,
                  kv_pos=None, q_pos=None) -> torch.Tensor:
    """:func:`attend` for a call that no kernel takes (a chunk of more than
    128 queries per KV head over a shared segment, with ALiBi or with
    logical positions), over rows dequantized in q's dtype for a q8 cache
    (the JAX einsum path's rounding point).  On the card each call counts
    like a kernel launch."""
    if isinstance(k_cache, QuantKV):
        k_cache = dequantize_rows(k_cache, q.dtype)
        v_cache = dequantize_rows(v_cache, q.dtype)
    out = attend(q, k_cache, v_cache, n_past, scale, sliding_window,
                 logit_softcap, sinks, kv_pos=kv_pos, q_pos=q_pos,
                 alibi_slopes=alibi_slopes, shared_k=shared_k, shared_v=shared_v)
    if q.is_cuda:
        attend_einsum.launches += 1
    return out


def mha_with_cache(q, k_new, v_new, k_cache, v_cache, n_past, scale: float,
                   sliding_window: int = 0, logit_softcap: float = 0.0,
                   sinks=None, kv_pos=None, q_pos=None, alibi_slopes=None,
                   shared_k=None, shared_v=None):
    """Insert the new rows (quantized first for a ``QuantKV`` cache), then
    attend.  Returns (out (B, T, Hq, Dh), k_cache, v_cache); the caches are
    updated in place."""
    if shared_k is not None and kv_pos is not None:
        raise NotImplementedError("shared-prefix KV + self-extend positions")
    quant = isinstance(k_cache, QuantKV)
    if quant:
        insert_quant(k_cache, k_new, n_past)
        insert_quant(v_cache, v_new, n_past)
    else:
        insert_kv(k_cache, k_new, n_past)
        insert_kv(v_cache, v_new, n_past)
    B, T, Hq, _ = q.shape
    G = Hq // k_cache.shape[2]
    extra = dict(shared_k=shared_k, shared_v=shared_v, alibi_slopes=alibi_slopes,
                 kv_pos=kv_pos, q_pos=q_pos)
    if G * T <= MAX_QUERIES:
        out = flash_decode(q, k_cache, v_cache, n_past, scale, sliding_window,
                           logit_softcap, sinks, **extra)
    elif shared_k is not None or alibi_slopes is not None or kv_pos is not None:
        out = attend_einsum(q, k_cache, v_cache, n_past, scale, sliding_window,
                            logit_softcap, sinks, **extra)
    elif quant:
        out = flash_attention(q, k_cache.q, v_cache.q, n_past, scale,
                              sliding_window, logit_softcap, sinks,
                              k_scales=k_cache.s, v_scales=v_cache.s)
    else:
        out = flash_attention(q, k_cache, v_cache, n_past, scale,
                              sliding_window, logit_softcap, sinks)
    return out, k_cache, v_cache

