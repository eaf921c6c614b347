"""Sampler chain, greedy path (port of
``llama_cpp_gfx906_tpu/sampling/samplers.py``: ``SamplerParams`` and the
greedy branch of ``SamplerChain``).

Sampling runs on host numpy over the last position's logits: logit bias,
repetition penalties, then argmax.  The stochastic samplers, DRY, infill,
mirostat and grammar constraints are not ported yet and raise.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class SamplerParams:
    """The fields of the JAX package's ``SamplerParams`` that the greedy
    path and the on-device sampler (``ops/sampling_ops.py``) read, with its
    defaults."""

    seed: int = 0xFFFFFFFF
    temp: float = 0.8
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.05
    penalty_last_n: int = 64
    penalty_repeat: float = 1.0
    penalty_freq: float = 0.0
    penalty_present: float = 0.0
    logit_bias: dict[int, float] = field(default_factory=dict)
    greedy: bool = False


def apply_logit_bias(logits: np.ndarray, bias: dict[int, float]) -> np.ndarray:
    for tok, b in bias.items():
        logits[tok] += b
    return logits


def apply_penalties(logits: np.ndarray, prev: list[int], last_n: int,
                    repeat: float, freq: float, present: float) -> np.ndarray:
    if last_n == 0 or (repeat == 1.0 and freq == 0.0 and present == 0.0):
        return logits
    window = prev[-last_n:] if last_n > 0 else prev
    if not window:
        return logits
    toks, counts = np.unique(np.asarray(window), return_counts=True)
    vals = logits[toks]
    if repeat != 1.0:
        vals = np.where(vals <= 0, vals * repeat, vals / repeat)
    logits[toks] = vals - counts * freq - (counts > 0) * present
    return logits


class SamplerChain:
    def __init__(self, params: SamplerParams, n_vocab: int):
        if not (params.greedy or params.temp <= 0):
            raise NotImplementedError("only greedy sampling is ported yet")
        self.p = params
        self.n_vocab = n_vocab

    def accept(self, token_id: int, is_eog: bool = False) -> None:
        """Commit a sampled token (no stateful sampler in the greedy path)."""

    def sample(self, logits: np.ndarray, prev_tokens: list[int]) -> int:
        p = self.p
        logits = np.asarray(logits, np.float32).copy()
        if p.logit_bias:
            logits = apply_logit_bias(logits, p.logit_bias)
        logits = apply_penalties(logits, prev_tokens, p.penalty_last_n,
                                 p.penalty_repeat, p.penalty_freq,
                                 p.penalty_present)
        return int(np.argmax(logits))
