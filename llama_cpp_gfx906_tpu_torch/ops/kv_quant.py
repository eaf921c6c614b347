"""Quantized (q8) KV-cache storage (port of
``llama_cpp_gfx906_tpu/ops/kv_quant.py``).

int8 values plus one f32 scale per (position, head) row vector, in the JAX
layout: ``q`` (..., S, H, D) int8 and ``s`` (..., S, H, 1) f32, so that
parity compares bytes.  The K3/K4 kernels read both planes as they are and
dequantize in the kernel; :func:`dequantize_rows` is for the plain versions
and the CPU path.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class QuantKV:
    """int8 rows and per-row scales; mirrors a (..., S, H, D) cache tensor.
    Indexing applies to both planes over the leading (non-D) axes, so
    ``cache[l]`` is one layer and ``cache[:, s:s + 1]`` one slot, both views."""

    q: torch.Tensor  # (..., S, H, D) int8
    s: torch.Tensor  # (..., S, H, 1) f32

    @classmethod
    def zeros(cls, shape, device="cpu") -> "QuantKV":
        return cls(q=torch.zeros(shape, dtype=torch.int8, device=device),
                   s=torch.zeros((*shape[:-1], 1), dtype=torch.float32, device=device))

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return torch.int8

    @property
    def device(self):
        return self.q.device

    @property
    def nbytes(self) -> int:
        return self.q.nbytes + self.s.nbytes

    def __getitem__(self, idx) -> "QuantKV":
        return QuantKV(q=self.q[idx], s=self.s[idx])

    def is_contiguous(self) -> bool:
        return self.q.is_contiguous() and self.s.is_contiguous()


def quantize_rows(x: torch.Tensor) -> QuantKV:
    """Per-(pos, head) symmetric int8: scale = absmax / 127 along D, values
    multiplied by the reciprocal, rounded half to even and clipped to
    +-127, as the JAX function computes them."""
    xf = x.float()
    scale = xf.abs().amax(-1, keepdim=True) / 127.0
    pos = scale > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, scale, torch.ones_like(scale)),
                      torch.zeros_like(scale))
    q = torch.clamp(torch.round(xf * inv), -127, 127).to(torch.int8)
    return QuantKV(q=q, s=scale)


def dequantize_rows(kv: QuantKV, dtype=torch.bfloat16) -> torch.Tensor:
    return (kv.q.float() * kv.s).to(dtype)


def take_rows(kv: QuantKV, src: torch.Tensor, axis: int) -> QuantKV:
    """Row permutation on a quantized cache: the int8 payload and the scales
    move together, with no dequantization (the context shift's V rows)."""
    return QuantKV(q=torch.index_select(kv.q, axis, src),
                   s=torch.index_select(kv.s, axis, src))


def insert_quant(cache: QuantKV, new: torch.Tensor, n_past: torch.Tensor) -> None:
    """Quantize the new rows (B, T, H, D) and write them at each sequence's
    offset into ``cache`` (B, S, H, D), in place (the quantized counterpart
    of ``ops.attention.insert_kv``)."""
    from .attention import insert_kv

    nq = quantize_rows(new)
    insert_kv(cache.q, nq.q, n_past)
    insert_kv(cache.s, nq.s, n_past)
