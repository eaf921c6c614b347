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
scaled by a sigmoid gate, to the routed FFN (:func:`shared_expert`).  The
ALiBi families (mpt, bloom) take LayerNorms (with biases where the file
has them), no rope, ALiBi slopes on the attention scores, the output
projection's bias, an ungated FFN with its biases, bloom's norm after the
embedding and biases on the final norm and the head.  gpt-oss rides it too:
q/k/v and o biases, attention sinks, alternating sliding windows (even
layers windowed) and the routed FFN with its router and expert biases.

Single-token decode on the card goes through one decode kernel for the
whole stack where the JAX forward sends it to one on its accelerator: K7
(``ops/decode_step.py``) for layers of at most 6 MiB of quantized planes,
K6 (``ops/decode_stream.py``) for larger ones, each behind its gate (which
refuses a q8 cache and a shared segment, as the JAX gates do);
everything else, and everything on the CPU, takes the per-layer loop.  The
rope frequencies and the ALiBi slopes live on the device once per (cfg,
device), so a step has no host-to-device copy.

The cache is bf16/f32 or q8 (``ops/kv_quant.QuantKV`` per K and V), and may
carry a shared-prefix segment (one system prompt's rows, stored once for
the whole batch): its S0 rows sit at logical positions 0..S0-1, so every
own token is roped and masked at S0 + its row.  A cache may also carry
self-extend logical positions (``KVCache.pos``, set by the engine's
``seq_div`` / ``seq_add``): tokens are then roped and masked at their
logical positions, which the step writes into the plane before its layers
run, so a new token sees its own row.  (The JAX forward writes them after
the step: its new tokens do not attend to their own rows under
self-extend.)
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..ops.attention import alibi_slopes_on, mha_with_cache
from ..ops.decode_step import _fused_ok, fused_decode_step
from ..ops.decode_stream import _stream_ok, fused_decode_step_streamed
from ..ops.kv_quant import QuantKV
from ..ops.moe import moe_ffn
from ..ops.norms import layer_norm, rms_norm
from ..ops.quant_matmul import QuantTensor, linear
from ..ops.rope import apply_rope, layer_inv_freqs
from .config import ModelConfig


@dataclass
class KVCache:
    """KV cache (L, B, S, Hkv, Dh) per K and V (a tensor, or a ``QuantKV``
    for a q8 cache), updated in place, the per-sequence fill level
    ``n_past`` (B,) int32 on the cache's device, the optional
    shared-prefix rows ``shared_k``/``shared_v`` (L, 1, S0, Hkv, Dh) in the
    compute dtype, and the optional self-extend planes: ``pos`` (B, S)
    int32, each row's logical position (``POS_SENTINEL`` past the fill
    level), and ``pos_next`` (B,) int32, the next token's (JAX ``KVCache``
    ``pos`` / ``pos_next``); both are updated in place."""

    k: torch.Tensor | QuantKV
    v: torch.Tensor | QuantKV
    n_past: torch.Tensor
    shared_k: torch.Tensor | None = None
    shared_v: torch.Tensor | None = None
    pos: torch.Tensor | None = None
    pos_next: torch.Tensor | None = None

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


POS_SENTINEL = 1 << 30  # the logical position of a row past the fill level


def advance(kv: KVCache, T: int) -> None:
    """Move the fill level (and the next logical position) on by T rows."""
    kv.n_past += T
    if kv.pos_next is not None:
        kv.pos_next += T


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
    segment, logical positions, contiguity) and held with the params, and
    the kernels' plane table is built with it.  A cache with logical
    positions takes the loop: both gates refuse it, as JAX's do."""
    quant = isinstance(kv.k, QuantKV)
    key = (kv.k.shape[1], kv.max_seq, "q8" if quant else kv.k.dtype,
           kv.k.device, kv.shared_k is not None, kv.pos is not None,
           kv.k.is_contiguous())
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


def norm(x: torch.Tensor, w: torch.Tensor, b, cfg: ModelConfig) -> torch.Tensor:
    """The model's norm: LayerNorm (with bias ``b`` where given) or RMS
    (JAX ``_norm``)."""
    if cfg.norm_type == "layer":
        return layer_norm(x, w, b, cfg.rms_eps)
    return rms_norm(x, w, cfg.rms_eps)


def _opt(p, key: str):
    return p[key] if key in p else None


def embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The embedded tokens (B, T, D), scaled (gemma) in f32 and rounded back
    to the embedding's dtype, then normed where the model norms them
    (bloom), as JAX ``forward`` does before any route."""
    x = params["tok_emb"][tokens]
    if cfg.embedding_scale != 1.0:
        x = (x.float() * cfg.embedding_scale).to(x.dtype)
    if "tok_norm" in params:
        x = norm(x, params["tok_norm"], _opt(params, "tok_norm_b"), cfg)
    return x


def head(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Logits (B, T, V) f32 of the last hidden states x: the final norm,
    the head and its bias where the model has one."""
    x = norm(x, params["out_norm"], _opt(params, "out_norm_b"), cfg)
    logits = linear(x, params["lm_head"]).float()
    if "lm_head_b" in params:
        logits = logits + params["lm_head_b"].float()
    return logits


def _ffn(h: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """The dense FFN: gated (gate|up fused or apart), or the ungated
    act(h W_up + b_up) W_down + b_down of the ALiBi families (JAX
    ``_mlp_plain``)."""
    if "wgateup_fused" in p:
        gu = linear(h, p["wgateup_fused"])
        return linear(_act(gu[..., : cfg.n_ff], cfg.act_fn) * gu[..., cfg.n_ff:],
                      p["w_down"])
    if "w_gate" in p:
        return linear(_act(linear(h, p["w_gate"]), cfg.act_fn) * linear(h, p["w_up"]),
                      p["w_down"])
    u = linear(h, p["w_up"])
    if "b_up" in p:
        u = u + p["b_up"]
    out = linear(_act(u, cfg.act_fn), p["w_down"])
    return out + p["b_down"] if "b_down" in p else out


def layers_forward(params, cfg: ModelConfig, x: torch.Tensor,
                   kv: KVCache) -> torch.Tensor:
    """The per-layer loop: x (B, T, D) through every layer; the T new K/V
    rows land at n_past in place (n_past is not advanced here).  Tokens sit
    at logical positions n_shared + n_past + t, or, where the cache carries
    logical positions, at pos_next + t, which are first written into its
    plane at the new rows."""
    B, T = x.shape[:2]
    dev = x.device
    inv_freqs = layer_inv_freqs(cfg, dev)
    windows = cfg.layer_windows
    steps = torch.arange(T, device=dev)[None, :]
    logical = kv.pos is not None
    start = kv.pos_next if logical else kv.n_past
    positions = kv.n_shared + start.long()[:, None] + steps
    if logical:
        rows = kv.n_past.long()[:, None] + steps
        kv.pos[torch.arange(B, device=dev)[:, None], rows] = positions.to(kv.pos.dtype)
    pos_args = dict(kv_pos=kv.pos, q_pos=positions) if logical else {}
    if cfg.alibi:
        pos_args["alibi_slopes"] = alibi_slopes_on(cfg.n_heads, dev)
    scale = cfg.attn_scale or cfg.head_dim ** -0.5
    Dq = cfg.n_heads * cfg.head_dim
    Dkv = cfg.n_kv_heads * cfg.head_dim
    for li, p in enumerate(params["layers"]):
        h = norm(x, p["attn_norm"], _opt(p, "attn_norm_b"), cfg)
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
        if cfg.pos_emb == "rope":
            q = apply_rope(q, positions, inv_freqs[li], cfg.rope_interleaved)
            k = apply_rope(k, positions, inv_freqs[li], cfg.rope_interleaved)
        v = v.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
        shared = {}
        if kv.shared_k is not None:
            shared = dict(shared_k=kv.shared_k[li], shared_v=kv.shared_v[li])
        attn, _, _ = mha_with_cache(q, k, v, kv.k[li], kv.v[li], kv.n_past, scale,
                                    sliding_window=windows[li], sinks=_opt(p, "sinks"),
                                    **shared, **pos_args)
        attn = linear(attn.reshape(B, T, Dq), p["wo"])
        if "bo" in p:
            attn = attn + p["bo"]
        if cfg.post_attn_norm:
            attn = rms_norm(attn, p["post_attn_norm"], cfg.rms_eps)
        x = x + attn
        h = norm(x, p["ffn_norm"], _opt(p, "ffn_norm_b"), cfg)
        if "moe_gate_inp" in p:
            mlp = moe_ffn(h, p["moe_gate_inp"], p["moe_gate"], p["moe_up"],
                          p["moe_down"], cfg, router_b=_opt(p, "moe_gate_inp_b"),
                          gate_b=_opt(p, "moe_gate_b"), up_b=_opt(p, "moe_up_b"),
                          down_b=_opt(p, "moe_down_b"))
            if "shexp_gateup_fused" in p or "shexp_gate" in p:
                mlp = mlp + shared_expert(h, p, cfg)
        else:
            mlp = _ffn(h, p, cfg)
        if cfg.post_ffn_norm:
            mlp = rms_norm(mlp, p["post_ffn_norm"], cfg.rms_eps)
        x = x + mlp
    return x


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, kv: KVCache,
            last_only: bool = False) -> tuple[torch.Tensor, KVCache]:
    """One forward step (prefill or decode) over tokens (B, T).

    Returns (logits (B, T, V) f32, kv) with the cache advanced by T rows
    (and, with logical positions, the next position by T);
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
    logits = head(params, cfg, x)
    advance(kv, T)
    return logits, kv
