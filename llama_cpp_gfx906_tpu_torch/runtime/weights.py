"""GGUF tensors -> the port's parameters (port of
``llama_cpp_gfx906_tpu/runtime/weights.py``, plain llama).

Parameters are a :class:`ParamDict` module: ``tok_emb``, ``out_norm``,
``lm_head`` and ``layers``, an ``nn.ModuleList`` of per-layer ParamDicts
(the JAX package stacks layers as (L, K, N) arrays for ``lax.scan``; the
port keeps one tensor per layer).  Matmul weights are (K, N) dense tensors
or :class:`QuantTensor` modules whose planes are byte-identical to the JAX
package's per-layer slices.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..gguf.constants import GGMLType
from ..models.config import ModelConfig
from ..ops.quant_matmul import (
    QuantTensor,
    _SCALE_PART_DECODERS,
    _fold_streams,
    pack_gguf_tensor,
    pad_qt_n,
    supported_qmm_types,
)

EMBD = "token_embd.weight"
OUT_NORM = "output_norm.weight"
OUTPUT = "output.weight"

_LAYER_NAMES = {
    "attn_norm": "attn_norm.weight",
    "wq": "attn_q.weight",
    "wk": "attn_k.weight",
    "wv": "attn_v.weight",
    "wo": "attn_output.weight",
    "ffn_norm": "ffn_norm.weight",
    "w_gate": "ffn_gate.weight",
    "w_up": "ffn_up.weight",
    "w_down": "ffn_down.weight",
}
# weights consumed as x @ W: GGUF stores (out, in), so these transpose
_MATMUL = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


class ParamDict(nn.Module):
    """Named tensors (buffers) and modules with dict-style access."""

    def __init__(self, entries: dict | None = None):
        super().__init__()
        for k, v in (entries or {}).items():
            self[k] = v

    def __setitem__(self, key: str, value) -> None:
        if isinstance(value, nn.Module):
            self.add_module(key, value)
        else:
            self.register_buffer(key, value)

    def __getitem__(self, key: str):
        if key not in self:
            raise KeyError(key)
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._buffers or key in self._modules

    def keys(self) -> list[str]:
        return [*self._buffers, *self._modules]


def _dense(t, dtype, device, transpose: bool = False) -> torch.Tensor:
    """A GGUF tensor as a dense torch tensor on ``device``.  F16/F32 bytes
    convert there; quantized types decode on the host."""
    if t.ggml_type in (GGMLType.F16, GGMLType.F32):
        view = torch.float16 if t.ggml_type == GGMLType.F16 else torch.float32
        raw = torch.from_numpy(np.array(t.data, np.uint8, copy=True))
        arr = raw.to(device).view(view).reshape(t.shape)
    else:
        arr = torch.from_numpy(t.to_f32()).to(device)
    if transpose:
        arr = arr.T
    return arr.to(dtype).contiguous()


def _put_layers(layers: list[dict], fuse: bool) -> nn.ModuleList:
    return nn.ModuleList(ParamDict(fuse_projections(p) if fuse else p)
                         for p in layers)


def load_llama_params(reader, cfg: ModelConfig, dtype=torch.bfloat16,
                      device="cpu") -> ParamDict:
    """Dense load: every tensor dequantized to ``dtype`` (norms stay f32)."""
    t = reader.tensors
    params = ParamDict({
        "tok_emb": _dense(t[EMBD], dtype, device),
        "out_norm": _dense(t[OUT_NORM], torch.float32, device),
        "lm_head": (_dense(t[OUTPUT], dtype, device, transpose=True)
                    if OUTPUT in t else _dense(t[EMBD], dtype, device, True)),
    })
    layers = []
    for i in range(cfg.n_layers):
        p = {}
        for key, name in _LAYER_NAMES.items():
            info = t[f"blk.{i}.{name}"]
            p[key] = (_dense(info, dtype, device, transpose=True)
                      if key in _MATMUL else _dense(info, torch.float32, device))
        layers.append(p)
    params["layers"] = _put_layers(layers, fuse=False)
    return params


def load_llama_params_quantized(reader, cfg: ModelConfig, dtype=torch.bfloat16,
                                device="cpu") -> ParamDict:
    """Keep matmul weights block-quantized on the device.

    K-quant scales fold (the JAX loaders' default), decided per model as
    the JAX package does: they fold only when every projection is a k-quant
    whose K the folded layout serves, else all stay on plain f32 planes.  A
    quantized head wider than 8192 is zero-padded to a multiple of 2048
    columns.  Types without a device layout, like F16, load dense in
    ``dtype``.  q/k/v and gate/up are fused (:func:`fuse_projections`)."""
    t = reader.tensors
    qmm_ok = set(supported_qmm_types())

    def quantizable(info):
        return info.ggml_type in qmm_ok and info.shape[-1] % 32 == 0

    params = ParamDict({
        "tok_emb": _dense(t[EMBD], dtype, device),
        "out_norm": _dense(t[OUT_NORM], torch.float32, device),
    })
    if OUTPUT in t and quantizable(t[OUTPUT]):
        head = t[OUTPUT]
        fold_head = _fold_streams(int(head.shape[-1]), head.ggml_type)
        qt = pack_gguf_tensor(head.data, head.ggml_type, head.shape,
                              fold_scales=fold_head, device=device)
        if qt.N >= 8192 and qt.N % 2048:
            qt = pad_qt_n(qt)
        params["lm_head"] = qt
    else:
        params["lm_head"] = _dense(t.get(OUTPUT, t[EMBD]), dtype, device, True)

    names = [{k: t[f"blk.{i}.{n}"] for k, n in _LAYER_NAMES.items()}
             for i in range(cfg.n_layers)]
    fold = all(
        info.ggml_type in _SCALE_PART_DECODERS
        and _fold_streams(int(info.shape[-1]), info.ggml_type)
        for p in names for k, info in p.items() if k in _MATMUL)
    layers = []
    for p_infos in names:
        p = {}
        for key, info in p_infos.items():
            if key in _MATMUL and quantizable(info):
                p[key] = pack_gguf_tensor(info.data, info.ggml_type, info.shape,
                                          fold_scales=fold, device=device)
            elif key in _MATMUL:
                p[key] = _dense(info, dtype, device, transpose=True)
            else:
                p[key] = _dense(info, torch.float32, device)
        layers.append(p)
    params["layers"] = _put_layers(layers, fuse=True)
    return params


def _concat(parts: list):
    """Concatenate weights along the output dim (one launch instead of
    several), or None when their layouts differ."""
    if all(isinstance(p, torch.Tensor) for p in parts):
        return torch.cat(parts, -1)
    if not all(isinstance(p, QuantTensor) for p in parts):
        return None
    p0 = parts[0]
    layouts = {(p.fmt, p.K, p.group, p.sgroup, p.sd is not None, p.m is not None)
               for p in parts}
    if len(layouts) != 1 or any(p.q.shape[-1] != p.N for p in parts):
        return None

    def cat(name):
        planes = [getattr(p, name) for p in parts]
        return None if planes[0] is None else torch.cat(planes, -1)

    return QuantTensor(cat("q"), cat("s"), cat("m"), p0.fmt, p0.group,
                       (p0.K, sum(p.N for p in parts)), cat("sd"), cat("md"),
                       p0.sgroup)


def fuse_projections(p: dict) -> dict:
    """Fuse q/k/v -> ``wqkv_fused`` (or q|k -> ``wqk_fused`` with v apart
    when q/k are nib4c and v int8, the Q4_K_M split-v disposition) and
    gate/up -> ``wgateup_fused``."""
    out = dict(p)
    wq, wk, wv = p["wq"], p["wk"], p["wv"]
    qk_only = (all(isinstance(w, QuantTensor) for w in (wq, wk, wv))
               and wq.fmt == wk.fmt == "nib4c" and wv.fmt == "int8")
    keys = ("wq", "wk") if qk_only else ("wq", "wk", "wv")
    fused = _concat([p[k] for k in keys])
    if fused is not None:
        out["wqk_fused" if qk_only else "wqkv_fused"] = fused
        for k in keys:
            del out[k]
    fused = _concat([p["w_gate"], p["w_up"]])
    if fused is not None:
        out["wgateup_fused"] = fused
        del out["w_gate"], out["w_up"]
    return out


def layer_table(params: ParamDict, cfg: ModelConfig) -> torch.Tensor:
    """The decode kernels' (K6, K7) view of the layer stack: an int64 device
    table (L, 28) of, per layer, the addresses of the q, s, m, sd, md planes
    of the projections q|k|v (or q|k), v (split-v only), o, gate|up and down
    (0 where a plane is absent), then the attn_norm and ffn_norm vectors and
    the layer's sliding window.  The JAX package stacks the layers instead;
    the port builds this once, holds it with the params (whose tensors it
    points into) and reuses it every step.  Planes must be contiguous,
    16-byte aligned and on one device; otherwise this raises."""
    cached = params.__dict__.get("_layer_table")
    if cached is not None:
        return cached
    from ..ops.decode_stream import proj_keys

    layers = params["layers"]
    keys = proj_keys(layers[0])
    slots = (keys if len(keys) == 5 else (keys[0], None) + keys[1:])
    dev = layers[0]["attn_norm"].device

    def addr(t, align: int) -> int:
        if t is None:
            return 0
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError("decode table: planes must be contiguous, "
                             f"{align}-byte aligned and on {dev}")
        return t.data_ptr()

    rows = []
    for p in layers:
        row = []
        for k in slots:
            qt = p[k] if k else None
            row += [addr(getattr(qt, n) if qt else None, 16)
                    for n in ("q", "s", "m", "sd", "md")]
        for n in ("attn_norm", "ffn_norm"):
            if p[n].dtype != torch.float32:
                raise ValueError(f"decode table: {n} must be float32")
            row.append(addr(p[n], 4))
        row.append(cfg.sliding_window)
        rows.append(row)
    table = torch.tensor(rows, dtype=torch.int64).to(dev)
    params.__dict__["_layer_table"] = table
    return table


def _to_torch(a, device) -> torch.Tensor:
    a = np.array(a, copy=True)  # writable and contiguous
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: move the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(np_params: dict, cfg: ModelConfig, device="cpu") -> ParamDict:
    """Convert the JAX package's parameter tree (arrays as numpy, quantized
    weights as its QuantTensor with numpy planes) into the port's
    parameters: stacked (L, ...) arrays and planes become per-layer tensors,
    keeping dtypes and byte layout."""

    def conv(v, i=None):
        if hasattr(v, "fmt"):  # the JAX package's QuantTensor
            take = (lambda a: None if a is None else
                    _to_torch(a if i is None else a[i], device))
            return QuantTensor(take(v.q), take(v.s), take(v.m), v.fmt, v.group,
                               v.shape, take(v.sd), take(v.md), v.sgroup or 0)
        return _to_torch(v if i is None else v[i], device)

    params = ParamDict({k: conv(np_params[k])
                        for k in ("tok_emb", "out_norm", "lm_head")})
    params["layers"] = nn.ModuleList(
        ParamDict({k: conv(v, i) for k, v in np_params["layers"].items()})
        for i in range(cfg.n_layers))
    return params
