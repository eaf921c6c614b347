"""Llama forward pass (port of ``llama_cpp_gfx906_tpu/models/llama.py``,
plain-llama branches only).

Per layer: pre-norm, the fused q|k|v (or q|k + split v) projection, rope,
attention over the in-place KV cache, the output projection and residual,
then pre-norm, the fused gate|up projection with SiLU, the down projection
and residual.  The JAX package's ``lax.scan`` over stacked layers becomes a
Python loop over per-layer parameters.  The fused decode megakernels (K6,
K7) are not ported yet; the per-layer path runs the same math.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..ops.attention import mha_with_cache
from ..ops.norms import rms_norm
from ..ops.quant_matmul import linear
from ..ops.rope import apply_rope, rope_frequencies
from .config import ModelConfig


@dataclass
class KVCache:
    """KV cache (L, B, S, Hkv, Dh) per K and V, updated in place, and the
    per-sequence fill level ``n_past`` (B,) int32 on the cache's device."""

    k: torch.Tensor
    v: torch.Tensor
    n_past: torch.Tensor

    @classmethod
    def create(cls, cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device="cpu") -> "KVCache":
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   n_past=torch.zeros((batch,), dtype=torch.int32, device=device))

    @property
    def max_seq(self) -> int:
        return self.k.shape[2]


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, kv: KVCache,
            last_only: bool = False) -> tuple[torch.Tensor, KVCache]:
    """One forward step (prefill or decode) over tokens (B, T).

    Returns (logits (B, T, V) f32, kv) with the cache advanced by T rows;
    ``last_only`` computes the logits of the last position only (B, 1, V)."""
    B, T = tokens.shape
    dev = tokens.device
    inv_freq = torch.from_numpy(rope_frequencies(cfg)).to(dev)
    positions = kv.n_past.long()[:, None] + torch.arange(T, device=dev)[None, :]
    scale = cfg.attn_scale or cfg.head_dim ** -0.5
    Dq = cfg.n_heads * cfg.head_dim
    Dkv = cfg.n_kv_heads * cfg.head_dim

    x = params["tok_emb"][tokens]
    for li, p in enumerate(params["layers"]):
        h = rms_norm(x, p["attn_norm"], cfg.rms_eps)
        if "wqkv_fused" in p:
            qkv = linear(h, p["wqkv_fused"])
            q, k, v = qkv[..., :Dq], qkv[..., Dq:Dq + Dkv], qkv[..., Dq + Dkv:]
        elif "wqk_fused" in p:
            # q|k fused, v apart (Q4_K_M: a Q6_K attn_v beside Q4_K q/k)
            qk = linear(h, p["wqk_fused"])
            q, k = qk[..., :Dq], qk[..., Dq:]
            v = linear(h, p["wv"])
        else:
            q, k, v = (linear(h, p[n]) for n in ("wq", "wk", "wv"))
        q = apply_rope(q.reshape(B, T, cfg.n_heads, cfg.head_dim), positions,
                       inv_freq, cfg.rope_interleaved)
        k = apply_rope(k.reshape(B, T, cfg.n_kv_heads, cfg.head_dim), positions,
                       inv_freq, cfg.rope_interleaved)
        v = v.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
        attn, _, _ = mha_with_cache(q, k, v, kv.k[li], kv.v[li], kv.n_past, scale,
                                    sliding_window=cfg.sliding_window)
        x = x + linear(attn.reshape(B, T, Dq), p["wo"])
        h = rms_norm(x, p["ffn_norm"], cfg.rms_eps)
        if "wgateup_fused" in p:
            gu = linear(h, p["wgateup_fused"])
            g, u = gu[..., : cfg.n_ff], gu[..., cfg.n_ff:]
        else:
            g, u = linear(h, p["w_gate"]), linear(h, p["w_up"])
        x = x + linear(F.silu(g.float()).to(g.dtype) * u, p["w_down"])

    if last_only:
        x = x[:, -1:]
    x = rms_norm(x, params["out_norm"], cfg.rms_eps)
    logits = linear(x, params["lm_head"]).float()
    kv.n_past += T
    return logits, kv
