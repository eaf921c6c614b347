"""Attention over an in-place KV cache (port of
``llama_cpp_gfx906_tpu/ops/attention.py``).

Shapes:
  q:          (B, T, Hq, Dh)   new queries
  k/v new:    (B, T, Hkv, Dh)
  k/v cache:  (B, S, Hkv, Dh)  updated in place (the JAX package donates it)
  n_past:     (B,) int32       rows already in the cache, on q's device

:func:`attend` is the plain masked-softmax einsum: the oracle of the K3 and
K4 kernels and the CPU path.  On the card :func:`mha_with_cache` sends every
call to a kernel: K3 ``flash_decode`` when the G*T queries of a KV head fit
its 128-query limit, K4 ``flash_attention`` otherwise.  (The JAX package's
``S >= 4096`` condition for its decode kernel is about the TPU einsum reading
the whole allocation; it is not carried over.)
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention
from .flash_decode import MAX_QUERIES, flash_decode

NEG_INF = -1e30


def insert_kv(cache: torch.Tensor, new: torch.Tensor, n_past: torch.Tensor) -> None:
    """Write the new K or V rows at each sequence's offset, in place."""
    B, T = new.shape[:2]
    rows = n_past.long()[:, None] + torch.arange(T, device=new.device)[None, :]
    cache[torch.arange(B, device=new.device)[:, None], rows] = new.to(cache.dtype)


def attend(q, k_cache, v_cache, n_past, scale: float, sliding_window: int = 0,
           logit_softcap: float = 0.0, sinks=None, kv_pos=None, q_pos=None,
           alibi_slopes=None, shared_k=None, shared_v=None) -> torch.Tensor:
    """Masked-softmax attention of the T new queries over the cache, in f32;
    returns (B, T, Hq, Dh) in q's dtype.  ``kv_pos``/``q_pos`` (self-extend
    logical positions), ``alibi_slopes`` and the batch-shared prefix rows
    ``shared_k``/``shared_v`` (1, S0, Hkv, Dh) follow the JAX einsum path."""
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


def mha_with_cache(q, k_new, v_new, k_cache, v_cache, n_past, scale: float,
                   sliding_window: int = 0, logit_softcap: float = 0.0,
                   sinks=None, kv_pos=None, q_pos=None, alibi_slopes=None,
                   shared_k=None, shared_v=None):
    """Insert the new rows, then attend.  Returns (out (B, T, Hq, Dh),
    k_cache, v_cache); the caches are updated in place."""
    if shared_k is not None and kv_pos is not None:
        raise NotImplementedError("shared-prefix KV + self-extend positions")
    insert_kv(k_cache, k_new, n_past)
    insert_kv(v_cache, v_new, n_past)
    extra = dict(kv_pos=kv_pos, q_pos=q_pos, alibi_slopes=alibi_slopes,
                 shared_k=shared_k, shared_v=shared_v)
    if any(v is not None for v in extra.values()):
        if q.is_cuda:
            raise NotImplementedError(
                "ALiBi, self-extend and shared-prefix attention have no CUDA "
                "kernel yet")
        out = attend(q, k_cache, v_cache, n_past, scale, sliding_window,
                     logit_softcap, sinks, **extra)
        return out, k_cache, v_cache
    B, T, Hq, _ = q.shape
    G = Hq // k_cache.shape[2]
    attn = flash_decode if G * T <= MAX_QUERIES else flash_attention
    out = attn(q, k_cache, v_cache, n_past, scale, sliding_window,
               logit_softcap, sinks)
    return out, k_cache, v_cache
