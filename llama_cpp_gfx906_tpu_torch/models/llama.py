"""Llama forward pass (port of ``llama_cpp_gfx906_tpu/models/llama.py``,
plain-llama branches only).

Per layer: pre-norm, the fused q|k|v (or q|k + split v) projection, rope,
attention over the in-place KV cache, the output projection and residual,
then pre-norm, the fused gate|up projection with SiLU, the down projection
and residual.  The JAX package's ``lax.scan`` over stacked layers becomes a
Python loop over per-layer parameters (:func:`layers_forward`).

Single-token decode on the card goes through one decode kernel for the
whole stack where the JAX forward sends it to one on its accelerator: K7
(``ops/decode_step.py``) for layers of at most 6 MiB of quantized planes,
K6 (``ops/decode_stream.py``) for larger ones, each behind its gate;
everything else, and everything on the CPU, takes the per-layer loop.  The
rope frequencies live on the device once per (cfg, device), so a step has
no host-to-device copy.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..ops.attention import mha_with_cache
from ..ops.decode_step import _fused_ok, fused_decode_step
from ..ops.decode_stream import _stream_ok, fused_decode_step_streamed
from ..ops.norms import rms_norm
from ..ops.quant_matmul import QuantTensor, linear
from ..ops.rope import apply_rope, inv_freq_for
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


FUSED_LAYER_BYTES = 6 * 2**20  # K7 takes layers up to this many plane bytes


def layer_bytes(params) -> int:
    """q and s plane bytes of one layer's quantized weights (the JAX
    forward's K7/K6 split)."""
    return sum(t.q.nbytes + t.s.nbytes for t in params["layers"][0].children()
               if isinstance(t, QuantTensor))


def decode_route(params, cfg: ModelConfig, kv: KVCache) -> str | None:
    """"k7", "k6" or None (the per-layer loop) for single-token decode into
    ``kv`` on the card; decided once per (batch, length, cache dtype) and
    held with the params, and the kernels' plane table is built with it."""
    key = (kv.k.shape[1], kv.max_seq, kv.k.dtype, kv.k.device)
    routes = params.__dict__.setdefault("_decode_routes", {})
    if key not in routes:
        B = kv.k.shape[1]
        route = None
        if kv.k.is_cuda:
            small = layer_bytes(params) <= FUSED_LAYER_BYTES
            if small and _fused_ok(params, cfg, kv, B, 1):
                route = "k7"
            elif not small and _stream_ok(params, cfg, kv, B, 1):
                route = "k6"
        if route is not None:
            from ..runtime.weights import layer_table

            layer_table(params, cfg)
        routes[key] = route
    return routes[key]


def layers_forward(params, cfg: ModelConfig, x: torch.Tensor,
                   kv: KVCache) -> torch.Tensor:
    """The per-layer loop: x (B, T, D) through every layer; the T new K/V
    rows land at n_past in place (n_past is not advanced here)."""
    B, T = x.shape[:2]
    dev = x.device
    inv_freq = inv_freq_for(cfg, dev)
    positions = kv.n_past.long()[:, None] + torch.arange(T, device=dev)[None, :]
    scale = cfg.attn_scale or cfg.head_dim ** -0.5
    Dq = cfg.n_heads * cfg.head_dim
    Dkv = cfg.n_kv_heads * cfg.head_dim
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
    return x


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, kv: KVCache,
            last_only: bool = False) -> tuple[torch.Tensor, KVCache]:
    """One forward step (prefill or decode) over tokens (B, T).

    Returns (logits (B, T, V) f32, kv) with the cache advanced by T rows;
    ``last_only`` computes the logits of the last position only (B, 1, V)."""
    T = tokens.shape[1]
    x = params["tok_emb"][tokens]
    route = decode_route(params, cfg, kv) if T == 1 and x.is_cuda else None
    if route == "k7":
        x = fused_decode_step(params, cfg, x, kv)
    elif route == "k6":
        x = fused_decode_step_streamed(params, cfg, x, kv)
    else:
        x = layers_forward(params, cfg, x, kv)
    if last_only:
        x = x[:, -1:]
    x = rms_norm(x, params["out_norm"], cfg.rms_eps)
    logits = linear(x, params["lm_head"]).float()
    kv.n_past += T
    return logits, kv
