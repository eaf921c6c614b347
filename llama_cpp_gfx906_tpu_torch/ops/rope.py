"""Rotary position embeddings (port of ``llama_cpp_gfx906_tpu/ops/rope.py``):
ggml NORM mode (interleaved pairs) and NEOX mode (half split), with linear
and llama-3 style frequency scaling.  Plain tensor code: elementwise work
that PyTorch runs as it is.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..gguf.constants import RopeScalingType
from ..models.config import ModelConfig


def rope_frequencies(cfg: ModelConfig) -> np.ndarray:
    """Per-pair inverse frequencies (f32, computed on the host in f64)."""
    rope_dim = cfg.rope_dim or cfg.head_dim
    inv_freq = 1.0 / (
        cfg.rope_base ** (np.arange(0, rope_dim, 2, dtype=np.float64) / rope_dim))
    if cfg.rope_scaling == RopeScalingType.LINEAR and cfg.rope_scale != 1.0:
        inv_freq = inv_freq / cfg.rope_scale
    elif cfg.rope_scaling == RopeScalingType.YARN and cfg.rope_orig_ctx:
        # llama3-style smooth interpolation between wavelength bands
        low_freq_wavelen = cfg.rope_orig_ctx / cfg.rope_low_freq_factor
        high_freq_wavelen = cfg.rope_orig_ctx / cfg.rope_high_freq_factor
        wavelen = 2 * math.pi / inv_freq
        smooth = np.clip(
            (cfg.rope_orig_ctx / wavelen - cfg.rope_low_freq_factor)
            / (cfg.rope_high_freq_factor - cfg.rope_low_freq_factor), 0.0, 1.0)
        scaled = inv_freq / cfg.rope_scale
        inv_freq = np.where(
            wavelen > low_freq_wavelen, scaled,
            np.where(wavelen < high_freq_wavelen, inv_freq,
                     (1 - smooth) * scaled + smooth * inv_freq))
    return inv_freq.astype(np.float32)


_INV_FREQ: dict = {}


def inv_freq_for(cfg: ModelConfig, device) -> torch.Tensor:
    """:func:`rope_frequencies` as a tensor on ``device``, copied there once
    per (cfg, device) and reused by every forward (a step then has no
    host-to-device copy and can be captured in a CUDA graph)."""
    key = (cfg, torch.device(device))
    t = _INV_FREQ.get(key)
    if t is None:
        t = _INV_FREQ[key] = torch.from_numpy(rope_frequencies(cfg)).to(device)
    return t


def apply_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor,
               interleaved: bool = True) -> torch.Tensor:
    """Rotate ``x`` (B, T, H, Dh) by ``positions`` (B, T).

    interleaved=True -> NORM mode, pairs (0,1), (2,3), ...;
    interleaved=False -> NEOX mode, pairs (i, i + rope_dim/2).
    Dims beyond ``2 * len(inv_freq)`` pass through unrotated."""
    rope_dim = 2 * inv_freq.shape[0]
    rot, rest = x[..., :rope_dim].float(), x[..., rope_dim:]
    angles = positions[:, :, None].float() * inv_freq  # (B, T, F)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    if interleaved:
        x0, x1 = rot[..., 0::2], rot[..., 1::2]
        out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], -1
                          ).reshape(rot.shape)
    else:
        x0, x1 = rot[..., : rope_dim // 2], rot[..., rope_dim // 2 :]
        out = torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], -1)
    return torch.cat([out.to(x.dtype), rest], -1) if rest.shape[-1] else out.to(x.dtype)
