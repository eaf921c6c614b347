"""RMS normalization (port of ``llama_cpp_gfx906_tpu/ops/norms.py::rms_norm``).

Accumulation is f32 whatever the activation dtype; the result returns in
the input's dtype.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return ((xf * scale) * weight.float()).to(x.dtype)
