"""Rotary position embeddings (port of ``llama_cpp_gfx906_tpu/ops/rope.py``):
ggml NORM mode (interleaved pairs) and NEOX mode (half split), with linear
and llama-3 style frequency scaling.  A gemma3 model rotates its SWA layers
with a local base and rope scaling off, its global layers with the (scaled)
global base (JAX ``models/llama.py`` ``forward``): :func:`layer_inv_freqs`.
Plain tensor code: elementwise work that PyTorch runs as it is.
"""

from __future__ import annotations

import dataclasses
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


def local_rope_cfg(cfg: ModelConfig) -> ModelConfig:
    """The config whose frequencies the SWA layers of a dual-base model
    (``rope_local_base`` > 0) rotate with: the local base, no scaling; the
    model's own config otherwise."""
    if cfg.rope_local_base <= 0:
        return cfg
    return dataclasses.replace(cfg, rope_base=cfg.rope_local_base,
                               rope_scaling=RopeScalingType.NONE)


_INV_FREQ: dict = {}


def inv_freq_for(cfg: ModelConfig, device, local: bool = False) -> torch.Tensor:
    """:func:`rope_frequencies` as a tensor on ``device`` (of
    :func:`local_rope_cfg` with ``local``), copied there once per (cfg,
    device) and reused by every forward (a step then has no host-to-device
    copy and can be captured in a CUDA graph)."""
    key = (local_rope_cfg(cfg) if local else cfg, torch.device(device))
    t = _INV_FREQ.get(key)
    if t is None:
        t = _INV_FREQ[key] = torch.from_numpy(rope_frequencies(key[0])).to(device)
    return t


def layer_inv_freqs(cfg: ModelConfig, device) -> list[torch.Tensor]:
    """Each layer's inverse frequencies: the local ones on an SWA layer of a
    dual-base model, the global ones elsewhere."""
    dual = cfg.rope_local_base > 0
    return [inv_freq_for(cfg, device, local=dual and swa) for swa in cfg.swa_layers]


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


def rope_shift_rows(k_cache: torch.Tensor, deltas: torch.Tensor,
                    inv_freq: torch.Tensor, interleaved: bool = True) -> torch.Tensor:
    """Re-rotate cached (already roped) K rows (L, B, S, H, Dh) by per-row
    position deltas (B, S) (0 leaves a row as it is): rotation by p + d is
    rotation by p, then by d, so a key moves from p to p + d by one more
    rope application (the context shift)."""
    L, B = k_cache.shape[:2]
    flat = k_cache.reshape(L * B, *k_cache.shape[2:])
    out = apply_rope(flat, deltas.repeat(L, 1), inv_freq, interleaved)
    return out.reshape(k_cache.shape)
