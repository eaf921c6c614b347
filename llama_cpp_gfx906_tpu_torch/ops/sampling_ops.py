"""Device-side batched sampling (port of
``llama_cpp_gfx906_tpu/ops/sampling_ops.py``).

The hot samplers (greedy, temperature, top-k, top-p, min-p, repetition
penalty) run on the logits' device over the top-``CAND`` candidates of each
slot, so a decode loop keeps only token ids on the host.  Plain PyTorch
ops with no host synchronisation: the engine captures them in its CUDA
graph of a decode step.  Greedy is exact; the Gumbel noise comes from
uniforms the caller draws from an explicit ``torch.Generator`` (the JAX
package draws it from a ``jax.random`` key, so the two agree on the
deterministic corners, not on samples).
"""

from __future__ import annotations

import torch

CAND = 256  # candidates kept per slot
NEG_INF = -1e30


_IDX_BITS = 20  # vocabularies up to 2^20 tokens


def top_candidates(logits: torch.Tensor, cand: int):
    """(values, indices) of the ``cand`` largest f32 logits per row,
    descending, equal values in ascending index order (``jax.lax.top_k``'s
    choice and order).  One ``topk`` over unique int64 keys: the logit's
    bits made order-preserving, then the index reversed in the low bits."""
    V = logits.shape[-1]
    if V > 1 << _IDX_BITS:
        raise ValueError(f"vocabulary of {V} tokens")
    bits = logits.float().contiguous().view(torch.int32).long()
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    tie = (1 << _IDX_BITS) - 1 - torch.arange(V, device=logits.device)
    idx = torch.topk(ordered * (1 << _IDX_BITS) + tie, cand, dim=-1).indices
    return logits.float().gather(-1, idx), idx


def sample_tokens(logits: torch.Tensor, uniforms: torch.Tensor,
                  temp: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor,
                  min_p: torch.Tensor, penalty_repeat: torch.Tensor,
                  recent_tokens: torch.Tensor, cand: int = CAND) -> torch.Tensor:
    """Sampled token ids (B,) int32 from logits (B, V) f32.

    Per slot (B,): ``temp`` (<= 0: greedy), ``top_k`` (0: off), ``top_p``
    (1: off), ``min_p`` (0: off), ``penalty_repeat`` (1: off) over
    ``recent_tokens`` (B, R) int32 padded with -1; ``uniforms`` (B, >= cand)
    in (0, 1) feed the Gumbel noise."""
    B, V = logits.shape
    cand = min(cand, V)
    vals, idx = top_candidates(logits.float(), cand)

    # repetition penalty on candidates present in the recent window
    in_recent = (idx[:, :, None] == recent_tokens[:, None, :]).any(-1)
    pr = penalty_repeat[:, None]
    penalized = torch.where(vals <= 0, vals * pr, vals / pr)
    vals = torch.where(in_recent & (pr != 1.0), penalized, vals)

    ranks = torch.arange(cand, device=logits.device)[None, :]
    k = torch.where(top_k[:, None] > 0, top_k[:, None], cand)
    vals = torch.where(ranks < k, vals, NEG_INF)

    # min-p: drop candidates below min_p x the top probability (log space)
    mx = vals.amax(-1, keepdim=True)
    floor = mx + torch.log(torch.clamp(min_p[:, None], min=1e-10))
    vals = torch.where((min_p[:, None] > 0) & (vals < floor), NEG_INF, vals)

    # top-p over the (already sorted) candidates; the first always stays
    probs = torch.softmax(vals, -1)
    keep = ((probs.cumsum(-1) - probs) < top_p[:, None]) | (ranks == 0)
    vals = torch.where(keep, vals, NEG_INF)

    scaled = vals / torch.clamp(temp[:, None], min=1e-6)
    u = torch.clamp(uniforms[:, :cand].float(), min=torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    rank = torch.where(temp <= 0, vals.argmax(-1), (scaled + gumbel).argmax(-1))
    return idx.gather(1, rank[:, None])[:, 0].to(torch.int32)
