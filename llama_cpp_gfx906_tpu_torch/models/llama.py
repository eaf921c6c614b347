"""Llama forward pass (port of ``llama_cpp_gfx906_tpu/models/llama.py``,
llama, MoE-llama, gemma3 and qwen branches).

Per layer: pre-norm, the fused q|k|v (or q|k + split v) projection, rope,
attention over the in-place KV cache, the output projection and residual,
then pre-norm, the fused gate|up projection with SiLU, the down projection
and residual; an MoE layer (Mixtral) takes the routed FFN
(``ops/moe.moe_ffn``) in place of the dense one.  The JAX package's ``lax.scan`` over stacked layers becomes a
Python loop over per-layer parameters (:func:`layers_forward`).  A gemma3
model (JAX's generalized forward with its gemma flags) scales the embedding
by sqrt(D) before any route, norms q and k per head before rope, rotates
its SWA layers with the local base, windows only those, norms the
attention and FFN outputs before their residual adds, and gates with
gelu-tanh.  The qwen families ride the same loop: qwen2 adds its q/k/v
biases after the projection, qwen3 norms q and k per head (one rope base,
no post-norms), and a qwen2moe layer adds its always-on shared expert,
scaled by a sigmoid gate, to the routed FFN (:func:`shared_expert`).

Single-token decode on the card goes through one decode kernel for the
whole stack where the JAX forward sends it to one on its accelerator: K7
(``ops/decode_step.py``) for layers of at most 6 MiB of quantized planes,
K6 (``ops/decode_stream.py``) for larger ones, each behind its gate (which
refuses a q8 cache and a shared segment, as the JAX gates do);
everything else, and everything on the CPU, takes the per-layer loop.  The
rope frequencies live on the device once per (cfg, device), so a step has
no host-to-device copy.

The cache is bf16/f32 or q8 (``ops/kv_quant.QuantKV`` per K and V), and may
carry a shared-prefix segment (one system prompt's rows, stored once for
the whole batch): its S0 rows sit at logical positions 0..S0-1, so every
own token is roped and masked at S0 + its row.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..ops.attention import mha_with_cache
from ..ops.decode_step import _fused_ok, fused_decode_step
from ..ops.decode_stream import _stream_ok, fused_decode_step_streamed
from ..ops.kv_quant import QuantKV
from ..ops.moe import moe_ffn
from ..ops.norms import rms_norm
from ..ops.quant_matmul import QuantTensor, linear
from ..ops.rope import apply_rope, layer_inv_freqs
from .config import ModelConfig


@dataclass
class KVCache:
    """KV cache (L, B, S, Hkv, Dh) per K and V (a tensor, or a ``QuantKV``
    for a q8 cache), updated in place, the per-sequence fill level
    ``n_past`` (B,) int32 on the cache's device, and the optional
    shared-prefix rows ``shared_k``/``shared_v`` (L, 1, S0, Hkv, Dh) in the
    compute dtype."""

    k: torch.Tensor | QuantKV
    v: torch.Tensor | QuantKV
    n_past: torch.Tensor
    shared_k: torch.Tensor | None = None
    shared_v: torch.Tensor | None = None

    @classmethod
    def create(cls, cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device="cpu") -> "KVCache":
        """``dtype`` "q8" makes a quantized cache (JAX ``create(..., "q8")``)."""
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        if dtype in ("q8", "q8_0"):
            k, v = QuantKV.zeros(shape, device), QuantKV.zeros(shape, device)
        else:
            k = torch.zeros(shape, dtype=dtype, device=device)
            v = torch.zeros(shape, dtype=dtype, device=device)
        return cls(k=k, v=v,
                   n_past=torch.zeros((batch,), dtype=torch.int32, device=device))

    @property
    def max_seq(self) -> int:
        return self.k.shape[2]

    @property
    def n_shared(self) -> int:
        return 0 if self.shared_k is None else self.shared_k.shape[2]

    @property
    def nbytes(self) -> int:
        """Bytes of the per-slot K and V storage (scales included)."""
        return self.k.nbytes + self.v.nbytes


FUSED_LAYER_BYTES = 6 * 2**20  # K7 takes layers up to this many plane bytes


def layer_bytes(params) -> int:
    """q and s plane bytes of one layer's dense quantized weights (the JAX
    forward's K7/K6 split; stacked experts are left out, as there)."""
    return sum(t.q.nbytes + t.s.nbytes for t in params["layers"][0].children()
               if isinstance(t, QuantTensor) and t.q.ndim == 2)


def _on_card(kv: KVCache) -> bool:
    return kv.k.device.type == "cuda"


def decode_route(params, cfg: ModelConfig, kv: KVCache) -> str | None:
    """"k7", "k6" or None (the per-layer loop) for single-token decode into
    ``kv`` on the card; decided once per (batch, length, cache kind, shared
    segment, contiguity) and held with the params, and the kernels' plane
    table is built with it."""
    quant = isinstance(kv.k, QuantKV)
    key = (kv.k.shape[1], kv.max_seq, "q8" if quant else kv.k.dtype,
           kv.k.device, kv.shared_k is not None, kv.k.is_contiguous())
    routes = params.__dict__.setdefault("_decode_routes", {})
    if key not in routes:
        B = kv.k.shape[1]
        route = None
        if _on_card(kv):
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


def _act(g: torch.Tensor, act_fn: str) -> torch.Tensor:
    """The FFN gate's activation in f32, back in g's dtype (JAX ``_act``)."""
    gf = g.float()
    if act_fn in ("gelu", "gelu_tanh"):
        out = F.gelu(gf, approximate="tanh")
    elif act_fn == "gelu_erf":
        out = F.gelu(gf)
    elif act_fn == "silu":
        out = F.silu(gf)
    else:
        raise NotImplementedError(f"act_fn {act_fn!r} is not ported")
    return out.to(g.dtype)


def shared_expert(h: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """The always-on shared expert of an MoE layer (qwen2moe; JAX
    ``models/llama.py:387-403``): act(g) * u through its down projection,
    times sigmoid(h · shexp_gate_inp) where the layer has that vector;
    gate|up fused or apart.  h (B, T, D) -> (B, T, D) in h's dtype."""
    if "shexp_gateup_fused" in p:
        gu = linear(h, p["shexp_gateup_fused"])
        Fs = gu.shape[-1] // 2
        g, u = gu[..., :Fs], gu[..., Fs:]
    else:
        g, u = linear(h, p["shexp_gate"]), linear(h, p["shexp_up"])
    out = linear(_act(g, cfg.act_fn) * u, p["shexp_down"])
    if "shexp_gate_inp" in p:
        gate = torch.sigmoid((h @ p["shexp_gate_inp"].to(h.dtype)).float())
        out = out * gate.to(out.dtype)
    return out


def embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The embedded tokens (B, T, D), scaled (gemma) in f32 and rounded back
    to the embedding's dtype, as JAX ``forward`` does before any route."""
    x = params["tok_emb"][tokens]
    if cfg.embedding_scale != 1.0:
        x = (x.float() * cfg.embedding_scale).to(x.dtype)
    return x


def layers_forward(params, cfg: ModelConfig, x: torch.Tensor,
                   kv: KVCache) -> torch.Tensor:
    """The per-layer loop: x (B, T, D) through every layer; the T new K/V
    rows land at n_past in place (n_past is not advanced here).  Tokens sit
    at logical positions n_shared + n_past + t."""
    B, T = x.shape[:2]
    dev = x.device
    inv_freqs = layer_inv_freqs(cfg, dev)
    windows = cfg.layer_windows
    positions = (kv.n_shared + kv.n_past.long()[:, None]
                 + torch.arange(T, device=dev)[None, :])
    scale = cfg.attn_scale or cfg.head_dim ** -0.5
    Dq = cfg.n_heads * cfg.head_dim
    Dkv = cfg.n_kv_heads * cfg.head_dim
    for li, p in enumerate(params["layers"]):
        h = rms_norm(x, p["attn_norm"], cfg.rms_eps)
        if "wqkv_fused" in p:
            qkv = linear(h, p["wqkv_fused"])
            if "bqkv_fused" in p:  # qwen2: q/k/v biases
                qkv = qkv + p["bqkv_fused"]
            q, k, v = qkv[..., :Dq], qkv[..., Dq:Dq + Dkv], qkv[..., Dq + Dkv:]
        elif "wqk_fused" in p:
            # q|k fused, v apart (Q4_K_M: a Q6_K attn_v beside Q4_K q/k)
            qk = linear(h, p["wqk_fused"])
            q, k = qk[..., :Dq], qk[..., Dq:]
            v = linear(h, p["wv"])
        else:
            q, k, v = (linear(h, p[n]) for n in ("wq", "wk", "wv"))
            if "bq" in p:
                q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        q = q.reshape(B, T, cfg.n_heads, cfg.head_dim)
        k = k.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
        if cfg.qk_norm:  # per head, before rope (gemma3, qwen3)
            q = rms_norm(q, p["q_norm"], cfg.rms_eps)
            k = rms_norm(k, p["k_norm"], cfg.rms_eps)
        q = apply_rope(q, positions, inv_freqs[li], cfg.rope_interleaved)
        k = apply_rope(k, positions, inv_freqs[li], cfg.rope_interleaved)
        v = v.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
        shared = {}
        if kv.shared_k is not None:
            shared = dict(shared_k=kv.shared_k[li], shared_v=kv.shared_v[li])
        attn, _, _ = mha_with_cache(q, k, v, kv.k[li], kv.v[li], kv.n_past, scale,
                                    sliding_window=windows[li], **shared)
        attn = linear(attn.reshape(B, T, Dq), p["wo"])
        if cfg.post_attn_norm:
            attn = rms_norm(attn, p["post_attn_norm"], cfg.rms_eps)
        x = x + attn
        h = rms_norm(x, p["ffn_norm"], cfg.rms_eps)
        if "moe_gate_inp" in p:
            mlp = moe_ffn(h, p["moe_gate_inp"], p["moe_gate"], p["moe_up"],
                          p["moe_down"], cfg)
            if "shexp_gateup_fused" in p or "shexp_gate" in p:
                mlp = mlp + shared_expert(h, p, cfg)
        else:
            if "wgateup_fused" in p:
                gu = linear(h, p["wgateup_fused"])
                g, u = gu[..., : cfg.n_ff], gu[..., cfg.n_ff:]
            else:
                g, u = linear(h, p["w_gate"]), linear(h, p["w_up"])
            mlp = linear(_act(g, cfg.act_fn) * u, p["w_down"])
        if cfg.post_ffn_norm:
            mlp = rms_norm(mlp, p["post_ffn_norm"], cfg.rms_eps)
        x = x + mlp
    return x


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, kv: KVCache,
            last_only: bool = False) -> tuple[torch.Tensor, KVCache]:
    """One forward step (prefill or decode) over tokens (B, T).

    Returns (logits (B, T, V) f32, kv) with the cache advanced by T rows;
    ``last_only`` computes the logits of the last position only (B, 1, V)."""
    T = tokens.shape[1]
    x = embed(params, cfg, tokens)
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
