"""K7: single-token decode of a small model through the whole layer stack
in one launch.

Port of ``llama_cpp_gfx906_tpu/ops/decode_step.py`` for the dense llama
modes: the gate (:func:`_fused_ok`, B = 1, fused q|k|v, int8 weights with
plain scales and no mins) and the entry point (:func:`fused_decode_step`)
with its plain version.  The kernel is the B = 1, int8, plain-scale
instantiation of ``csrc/decode_stream.cu`` (C entry ``lcg_decode_step``);
the contract is K6's (``ops/decode_stream.py``).  The JAX kernel pipelines
whole per-layer blocks through its on-chip memory, so the JAX forward
sends it only layers of at most 6 MiB; the port keeps that dispatch
(``models/llama.py``).
"""

from __future__ import annotations

import torch

from .. import kernels
from .decode_stream import decode_layers_plain, launch_decode, uniform_layers
from .quant_matmul import QuantTensor
from .rope import rope_frequencies

_KEYS = ("wqkv_fused", "wo", "wgateup_fused", "w_down")


def _int8_qt(t) -> bool:
    return (isinstance(t, QuantTensor) and t.fmt == "int8" and t.m is None
            and t.sd is None and t.q.ndim == 2 and t.q.shape[-1] == t.shape[1])


def _fused_ok(params, cfg, kv, B: int, T: int) -> bool:
    """The K7 gate: B = 1, T = 1, fused q|k|v, int8 plain-scale weights."""
    if T != 1 or B != 1:
        return False
    if kv.k.ndim != 5 or kv.k.shape[1] != B:
        return False
    if kv.k.dtype not in (torch.bfloat16, torch.float32):
        return False
    layers = params["layers"]
    p = layers[0]
    if not all(k in p for k in _KEYS + ("attn_norm", "ffn_norm")):
        return False
    if not uniform_layers(layers, _KEYS):
        return False
    if not all(_int8_qt(p[k]) for k in _KEYS):
        return False
    D, Dh, F_ = cfg.n_embd, cfg.head_dim, cfg.n_ff
    S = kv.k.shape[2]
    if not (D % 128 == 0 and Dh % 128 == 0 and F_ % 128 == 0 and S % 128 == 0):
        return False
    if 2 * len(rope_frequencies(cfg)) != Dh:
        return False  # partial rope
    if p["wqkv_fused"].shape != (D, (cfg.n_heads + 2 * cfg.n_kv_heads) * Dh):
        return False
    return p["wgateup_fused"].shape == (D, 2 * F_)


@kernels.counted("decode_step")
def fused_decode_step(params, cfg, x: torch.Tensor, kv) -> torch.Tensor:
    """K7: x (B = 1, 1, D) through every layer, the KV updated in place.
    On the CPU, the plain version."""
    if x.device.type == "cpu":
        return fused_decode_step_plain(params, cfg, x, kv)
    out = launch_decode(params, cfg, x, kv, k7=True)
    fused_decode_step.launches += 1
    return out


def fused_decode_step_plain(params, cfg, x, kv) -> torch.Tensor:
    """Plain version of K7 (the same contract as K6's)."""
    return decode_layers_plain(params, cfg, x, kv)
