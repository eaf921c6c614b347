"""Mixture-of-experts routed FFN (port of ``llama_cpp_gfx906_tpu/ops/moe.py``
for the llama family: Mixtral).

:func:`moe_ffn` routes each token to its top-k experts and dispatches on
the token count, as the JAX package does:

- at most 8 tokens (decode, a batched decode step): the routed path.  Each
  (token, expert) pair streams only its expert's slice: quantized experts
  through :func:`routed_quant_matmul` (K8 for int8 experts on the card, the
  quantized gather for nib4c ones), dense experts through a gather.  The
  expert ids stay on the device (no host sync), so a batched decode step
  is captured in a CUDA graph as it is;
- more tokens (prefill): every expert runs on every token, weighted by the
  combine matrix (zero where a token did not choose the expert), through
  ``quant_matmul`` per expert (K5 for int8 plain-scale experts on the card)
  or one einsum for dense experts.

Rounding points follow the JAX function: the router in f32, the top-k
weights rounded to x's dtype, each expert's output in f32 before it is
weighted and summed.  Single-token decode on the card takes K6's MoE leg
instead (``ops/decode_stream.py``), which routes inside the kernel.

Routing variants of other families raise ``NotImplementedError``: gpt-oss
(softmax over the selected logits, router and expert biases), llama4
(gate on the expert input), smallthinker (router fed the layer input) and
deepseek3 (selection bias).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .quant_matmul import QuantTensor, qt_expert, quant_matmul, routed_quant_matmul

GATHER_MAX_TOKENS = 8  # at most this many tokens take the routed path


def route(router_logits: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """(top-k weights f32 (N, k), expert ids int64 (N, k)) from f32 router
    logits (N, E): softmax or sigmoid, k masked-max passes (the first
    maximum on ties, as ``lax.top_k`` and K6 take it), then the optional
    renormalisation and scale."""
    if cfg.expert_gating_func == 2:  # LLAMA_EXPERT_GATING_FUNC_TYPE_SIGMOID
        probs = torch.sigmoid(router_logits)
    elif cfg.expert_gating_func == 1:
        probs = torch.softmax(router_logits, -1)
    else:
        raise NotImplementedError(f"expert gating function {cfg.expert_gating_func}")
    r = probs.clone()
    ids, vals = [], []
    for _ in range(cfg.n_experts_used):
        i = torch.argmax(r, -1, keepdim=True)
        ids.append(i)
        vals.append(torch.gather(probs, -1, i))
        r.scatter_(-1, i, float("-inf"))
    topv, topi = torch.cat(vals, -1), torch.cat(ids, -1)
    if cfg.expert_weights_norm:
        topv = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)
    if cfg.expert_weights_scale != 1.0:
        topv = topv * cfg.expert_weights_scale
    return topv, topi


def _silu_mul(g: torch.Tensor, u: torch.Tensor, dtype) -> torch.Tensor:
    return (F.silu(g.float()) * u.float()).to(dtype)


def moe_ffn(x: torch.Tensor, gate_inp: torch.Tensor, w_gate, w_up, w_down, cfg,
            probs_bias=None, router_b=None, gate_b=None, up_b=None, down_b=None,
            gate_x=None) -> torch.Tensor:
    """x (B, T, D) -> the routed FFN's output (B, T, D) in x's dtype.
    ``gate_inp`` is the router (D, E); the experts are stacked QuantTensors
    (q (E, K, N)) or dense (E, K, N) tensors."""
    for name, v in (("probs_bias (deepseek3 selection bias)", probs_bias),
                    ("router_b (gpt-oss router bias)", router_b),
                    ("gate_b/up_b/down_b (gpt-oss expert biases)",
                     gate_b if gate_b is not None else up_b if up_b is not None else down_b),
                    ("gate_x (smallthinker router input)", gate_x)):
        if v is not None:
            raise NotImplementedError(f"MoE variant not ported: {name}")
    if cfg.moe_topk_softmax:
        raise NotImplementedError("MoE variant not ported: moe_topk_softmax (gpt-oss)")
    if cfg.moe_scale_input:
        raise NotImplementedError("MoE variant not ported: moe_scale_input (llama4)")
    B, T, D = x.shape
    quantized = isinstance(w_gate, QuantTensor)
    E = w_gate.q.shape[0] if quantized else w_gate.shape[0]
    k = cfg.n_experts_used
    N = B * T
    xt = x.reshape(N, D)
    topv, topi = route(xt.float() @ gate_inp.float(), cfg)
    topv = topv.to(x.dtype)

    if N <= GATHER_MAX_TOKENS:
        if quantized:
            idx = topi.reshape(N * k)
            xp = xt.repeat_interleave(k, 0)  # (N k, D): one row per pair
            Fe = w_gate.shape[1]
            g = routed_quant_matmul(xp, w_gate, idx)
            u = routed_quant_matmul(xp, w_up, idx)
            h = _silu_mul(g, u, x.dtype)
            out = routed_quant_matmul(h.reshape(N * k, Fe), w_down, idx)
            out = out.reshape(N, k, D).float()
        else:
            xk = xt[:, None, :].expand(N, k, D).float()
            g = torch.einsum("nkd,nkdf->nkf", xk, w_gate[topi].float())
            u = torch.einsum("nkd,nkdf->nkf", xk, w_up[topi].float())
            h = _silu_mul(g.to(x.dtype), u.to(x.dtype), x.dtype)
            out = torch.einsum("nkf,nkfd->nkd", h.float(), w_down[topi].float())
        out = (out * topv[:, :, None].float()).sum(1)
    else:
        combine = torch.zeros((N, E), dtype=x.dtype, device=x.device)
        combine.scatter_(1, topi, topv)
        if quantized:
            out = torch.zeros((N, D), dtype=torch.float32, device=x.device)
            for e in range(E):
                ge = quant_matmul(xt, qt_expert(w_gate, e))
                ue = quant_matmul(xt, qt_expert(w_up, e))
                h = _silu_mul(ge, ue, x.dtype)
                oe = quant_matmul(h, qt_expert(w_down, e)).float()
                out = out + oe * combine[:, e, None].float()
        else:
            g = torch.einsum("nd,edf->enf", xt.float(), w_gate.float())
            u = torch.einsum("nd,edf->enf", xt.float(), w_up.float())
            h = _silu_mul(g.to(x.dtype), u.to(x.dtype), x.dtype)
            out_e = torch.einsum("enf,efd->end", h.float(), w_down.float())
            out = torch.einsum("end,ne->nd", out_e, combine.float())
    return out.to(x.dtype).reshape(B, T, D)
