"""Mixture-of-experts routed FFN (port of ``llama_cpp_gfx906_tpu/ops/moe.py``
for Mixtral, the MoE qwen families and gpt-oss).

:func:`moe_ffn` routes each token to its top-k experts and dispatches on
the token count, as the JAX package does:

- at most 8 tokens (decode, a batched decode step): the routed path.  Each
  (token, expert) pair streams only its expert's slice: quantized experts
  through :func:`routed_quant_matmul` (K8 for int8 and split-K nib4 experts
  on the card, the quantized gather for nib4c ones), dense experts through
  a gather.  The
  expert ids stay on the device (no host sync), so a batched decode step
  is captured in a CUDA graph as it is;
- more tokens (prefill): every expert runs on every token, weighted by the
  combine matrix (zero where a token did not choose the expert), through
  ``quant_matmul`` per expert (K5 for int8 plain-scale and split-K nib4
  experts on the card) or one einsum for dense experts.

Rounding points follow the JAX function: the router in f32 (plus its bias
where the layer has one), the top-k weights rounded to x's dtype, each
expert's gate and up in x's dtype (their biases added there on the routed
path, in f32 on the all-experts path, as JAX does), the activation in f32
back to x's dtype, each expert's output in f32 (plus its down bias) before
it is weighted and summed.  Single-token decode on the card takes K6's MoE
leg instead (``ops/decode_stream.py``) where its gate holds, which routes
inside the kernel.

gpt-oss's variants are ported: the router bias, the softmax over the
selected top-k logits (``moe_topk_softmax``), per-expert gate, up and down
biases and the ``swiglu_oai`` activation.  Variants of other families raise
``NotImplementedError``: llama4 (gate on the expert input), smallthinker
(router fed the layer input) and deepseek3 (selection bias).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .quant_matmul import QuantTensor, qt_expert, quant_matmul, routed_quant_matmul

GATHER_MAX_TOKENS = 8  # at most this many tokens take the routed path


def _top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, ids) of the k largest scores (N, E) in descending order: k
    masked-max passes, the first maximum on ties, as ``lax.top_k`` and K6
    take it."""
    r = scores.clone()
    ids, vals = [], []
    for _ in range(k):
        i = torch.argmax(r, -1, keepdim=True)
        ids.append(i)
        vals.append(torch.gather(scores, -1, i))
        r.scatter_(-1, i, float("-inf"))
    return torch.cat(vals, -1), torch.cat(ids, -1)


def route(router_logits: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """(top-k weights f32 (N, k), expert ids int64 (N, k)) from f32 router
    logits (N, E): gpt-oss's softmax over the top-k logits, or softmax /
    sigmoid over all experts, the top k, then the optional renormalisation
    and scale."""
    if cfg.moe_topk_softmax:
        topl, topi = _top_k(router_logits, cfg.n_experts_used)
        return torch.softmax(topl, -1), topi
    if cfg.expert_gating_func == 2:  # LLAMA_EXPERT_GATING_FUNC_TYPE_SIGMOID
        probs = torch.sigmoid(router_logits)
    elif cfg.expert_gating_func == 1:
        probs = torch.softmax(router_logits, -1)
    else:
        raise NotImplementedError(f"expert gating function {cfg.expert_gating_func}")
    topv, topi = _top_k(probs, cfg.n_experts_used)
    if cfg.expert_weights_norm:
        topv = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)
    if cfg.expert_weights_scale != 1.0:
        topv = topv * cfg.expert_weights_scale
    return topv, topi


def act_mix(g: torch.Tensor, u: torch.Tensor, cfg, dtype) -> torch.Tensor:
    """The experts' GLU in f32, rounded to ``dtype`` (JAX ``act_mix``):
    gpt-oss's swiglu_oai (gate clamped above at the limit, up to +-limit,
    ``(up + 1) g sigmoid(1.702 g)``), gelu-tanh, relu, else SiLU."""
    gf, uf = g.float(), u.float()
    if cfg.act_fn == "swiglu_oai":
        lim = cfg.swiglu_limit
        gf, uf = gf.clamp(max=lim), uf.clamp(-lim, lim)
        return ((uf + 1.0) * gf * torch.sigmoid(1.702 * gf)).to(dtype)
    if cfg.act_fn == "gelu":
        return (F.gelu(gf, approximate="tanh") * uf).to(dtype)
    if cfg.act_fn == "relu":
        return (F.relu(gf) * uf).to(dtype)
    return (F.silu(gf) * uf).to(dtype)


def moe_ffn(x: torch.Tensor, gate_inp: torch.Tensor, w_gate, w_up, w_down, cfg,
            probs_bias=None, router_b=None, gate_b=None, up_b=None, down_b=None,
            gate_x=None) -> torch.Tensor:
    """x (B, T, D) -> the routed FFN's output (B, T, D) in x's dtype.
    ``gate_inp`` is the router (D, E) and ``router_b`` its bias (E,); the
    experts are stacked QuantTensors (q (E, K, N)) or dense (E, K, N)
    tensors, ``gate_b`` / ``up_b`` (E, F) and ``down_b`` (E, D) their
    biases."""
    for name, v in (("probs_bias (deepseek3 selection bias)", probs_bias),
                    ("gate_x (smallthinker router input)", gate_x)):
        if v is not None:
            raise NotImplementedError(f"MoE variant not ported: {name}")
    if cfg.moe_scale_input:
        raise NotImplementedError("MoE variant not ported: moe_scale_input (llama4)")
    B, T, D = x.shape
    dt = x.dtype
    quantized = isinstance(w_gate, QuantTensor)
    E = w_gate.q.shape[0] if quantized else w_gate.shape[0]
    k = cfg.n_experts_used
    N = B * T
    xt = x.reshape(N, D)
    logits = xt.float() @ gate_inp.float()
    if router_b is not None:
        logits = logits + router_b.float()
    topv, topi = route(logits, cfg)
    topv = topv.to(dt)

    if N <= GATHER_MAX_TOKENS:
        if quantized:
            idx = topi.reshape(N * k)
            xp = xt.repeat_interleave(k, 0)  # (N k, D): one row per pair
            g = routed_quant_matmul(xp, w_gate, idx)
            u = routed_quant_matmul(xp, w_up, idx)
        else:
            xk = xt[:, None, :].expand(N, k, D).float()
            g = torch.einsum("nkd,nkdf->nkf", xk, w_gate[topi].float()).reshape(N * k, -1)
            u = torch.einsum("nkd,nkdf->nkf", xk, w_up[topi].float()).reshape(N * k, -1)
        if gate_b is not None:
            g = g + gate_b[topi].reshape(N * k, -1)
        if up_b is not None:
            u = u + up_b[topi].reshape(N * k, -1)
        h = act_mix(g.to(dt), u.to(dt), cfg, dt)
        if quantized:
            out = routed_quant_matmul(h, w_down, topi.reshape(N * k)).reshape(N, k, D).float()
        else:
            out = torch.einsum("nkf,nkfd->nkd", h.reshape(N, k, -1).float(),
                               w_down[topi].float())
        if down_b is not None:
            out = out + down_b[topi].float()
        out = (out * topv[:, :, None].float()).sum(1)
    else:
        combine = torch.zeros((N, E), dtype=dt, device=x.device)
        combine.scatter_(1, topi, topv)
        if quantized:
            out = torch.zeros((N, D), dtype=torch.float32, device=x.device)
            for e in range(E):
                gf = quant_matmul(xt, qt_expert(w_gate, e)).float()
                uf = quant_matmul(xt, qt_expert(w_up, e)).float()
                if gate_b is not None:
                    gf = gf + gate_b[e].float()
                if up_b is not None:
                    uf = uf + up_b[e].float()
                h = act_mix(gf.to(dt), uf.to(dt), cfg, dt)
                oe = quant_matmul(h, qt_expert(w_down, e)).float()
                if down_b is not None:
                    oe = oe + down_b[e].float()
                out = out + oe * combine[:, e, None].float()
        else:
            g = torch.einsum("nd,edf->enf", xt.float(), w_gate.float())
            u = torch.einsum("nd,edf->enf", xt.float(), w_up.float())
            if gate_b is not None:
                g = g + gate_b[:, None, :].float()
            if up_b is not None:
                u = u + up_b[:, None, :].float()
            h = act_mix(g.to(dt), u.to(dt), cfg, dt)
            out_e = torch.einsum("enf,efd->end", h.float(), w_down.float())
            if down_b is not None:
                out_e = out_e + down_b[:, None, :].float()
            out = torch.einsum("end,ne->nd", out_e, combine.float())
    return out.to(dt).reshape(B, T, D)
