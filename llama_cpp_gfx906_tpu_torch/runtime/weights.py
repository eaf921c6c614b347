"""GGUF tensors -> the port's parameters (port of
``llama_cpp_gfx906_tpu/runtime/weights.py``: llama, MoE llama, gemma3 and
the qwen families).

Parameters are a :class:`ParamDict` module: ``tok_emb``, ``out_norm``,
``lm_head`` and ``layers``, an ``nn.ModuleList`` of per-layer ParamDicts
(the JAX package stacks layers as (L, K, N) arrays for ``lax.scan``; the
port keeps one tensor per layer).  Matmul weights are (K, N) dense tensors
or :class:`QuantTensor` modules whose planes are byte-identical to the JAX
package's per-layer slices.  An MoE layer (Mixtral) holds the router
``moe_gate_inp`` (D, E) f32 and the stacked experts ``moe_gate``,
``moe_up`` (E, D, EF) and ``moe_down`` (E, EF, D) in place of the dense
FFN.  A gemma3 layer adds the f32 vectors ``q_norm``, ``k_norm`` (Dh,),
``post_attn_norm`` and ``post_ffn_norm`` (D,); a file without
``output.weight`` ties the head: ``lm_head`` is ``tok_emb.T`` in the compute
dtype, as the JAX loader makes it.  The qwen families add q/k/v biases
(qwen2, qwen2moe: ``bq``, ``bk``, ``bv`` in the compute dtype, fused with
the q|k|v weight into ``bqkv_fused``) and a shared expert (qwen2moe: its
gate and up fused into ``shexp_gateup_fused``, ``shexp_down``, and the
gate vector ``shexp_gate_inp`` (D, 1) in the compute dtype).  The ALiBi
families (mpt, bloom) store q/k/v fused as ``attn_qkv``: the loader splits
it into q, k and v by rows (each quant block lies within one row, so the
parts are the file's own bytes) and fuses them again as the other families
(:func:`effective_tensors`); bloom adds biases on every projection (``bo``,
``b_up``, ``b_down`` in the compute dtype), its LayerNorms' biases
(``attn_norm_b``, ``ffn_norm_b``, f32), a norm after the embedding
(``tok_norm``, ``tok_norm_b``) and the final norm's and the head's biases
(``out_norm_b``, ``lm_head_b``), all f32 as the JAX loader keeps them.
Both have an ungated FFN (``w_up``, ``w_down``).  gpt-oss adds, in the
compute dtype, the attention sinks ``sinks`` (Hq,), the o bias ``bo``, the
router's bias ``moe_gate_inp_b`` (E,) and the experts' biases
``moe_gate_b``, ``moe_up_b`` (E, EF, zero-padded as the experts are) and
``moe_down_b`` (E, D); its FFN pre-norm is the file's
``post_attention_norm`` (:func:`effective_tensors`).  Its Q4_0 gate and up
experts (K = D = 2880: no nib4c chunk) pack split-K nib4.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..gguf.constants import GGML_BLOCK_SIZES, GGMLType
from ..gguf.reader import TensorInfo
from ..models.config import ModelConfig
from ..ops.quant_matmul import (
    QuantTensor,
    _SCALE_PART_DECODERS,
    _fold_streams,
    pack_experts_int8_g16,
    pack_gguf_experts,
    pack_gguf_tensor,
    pad_qt_n,
    supported_qmm_types,
    values,
)

EMBD = "token_embd.weight"
OUT_NORM = "output_norm.weight"
OUTPUT = "output.weight"

# optional model-level f32 vectors (JAX runtime/weights.py:608-612)
_TOP_VECTORS = {"out_norm_b": "output_norm.bias", "tok_norm": "token_embd_norm.weight",
                "tok_norm_b": "token_embd_norm.bias", "lm_head_b": "output.bias"}
_LAYER_NAMES = {
    "attn_norm": "attn_norm.weight",
    "attn_norm_b": "attn_norm.bias",
    "wq": "attn_q.weight",
    "wk": "attn_k.weight",
    "wv": "attn_v.weight",
    "wo": "attn_output.weight",
    "bq": "attn_q.bias",
    "bk": "attn_k.bias",
    "bv": "attn_v.bias",
    "bo": "attn_output.bias",
    "q_norm": "attn_q_norm.weight",
    "k_norm": "attn_k_norm.weight",
    "post_attn_norm": "post_attention_norm.weight",
    "ffn_norm": "ffn_norm.weight",
    "ffn_norm_b": "ffn_norm.bias",
    "post_ffn_norm": "post_ffw_norm.weight",
    "w_gate": "ffn_gate.weight",
    "w_up": "ffn_up.weight",
    "w_down": "ffn_down.weight",
    "b_up": "ffn_up.bias",
    "b_down": "ffn_down.bias",
    "moe_gate_inp": "ffn_gate_inp.weight",
    "moe_gate_inp_b": "ffn_gate_inp.bias",
    "moe_gate": "ffn_gate_exps.weight",
    "moe_up": "ffn_up_exps.weight",
    "moe_down": "ffn_down_exps.weight",
    "moe_gate_b": "ffn_gate_exps.bias",
    "moe_up_b": "ffn_up_exps.bias",
    "moe_down_b": "ffn_down_exps.bias",
    "sinks": "attn_sinks.weight",
    "shexp_gate_inp": "ffn_gate_inp_shexp.weight",
    "shexp_gate": "ffn_gate_shexp.weight",
    "shexp_up": "ffn_up_shexp.weight",
    "shexp_down": "ffn_down_shexp.weight",
}
# weights consumed as x @ W: GGUF stores (out, in), so these transpose
_MATMUL = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "shexp_gate",
           "shexp_up", "shexp_down")
# vectors kept in the compute dtype (the JAX loader casts every layer
# tensor but the norms, their biases included); the shared expert's gate
# transposes to (D, 1)
_BIASES = ("bq", "bk", "bv")
_VECTORS = _BIASES + ("bo", "b_up", "b_down", "sinks", "moe_gate_inp_b", "moe_gate_b",
                      "moe_up_b", "moe_down_b")
# stacked experts (E, out, in) -> (E, in, out); the expert-FF dim pads to
# the streamed chunk grid (gate/up out, down in: both round the same EF)
_EXPERTS = {"moe_gate": dict(pad_n=True), "moe_up": dict(pad_n=True),
            "moe_down": dict(pad_k=True)}


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
    convert there; quantized types decode on the host.  ``transpose`` swaps
    the last two dims (stacked experts keep their leading axis)."""
    if t.ggml_type in (GGMLType.F16, GGMLType.F32):
        view = torch.float16 if t.ggml_type == GGMLType.F16 else torch.float32
        raw = torch.from_numpy(np.array(t.data, np.uint8, copy=True))
        arr = raw.to(device).view(view).reshape(t.shape)
    else:
        arr = torch.from_numpy(t.to_f32()).to(device)
    if transpose:
        arr = arr.transpose(-1, -2)
    return arr.to(dtype).contiguous()


def _router(t, dtype, device) -> torch.Tensor:
    """The router (E, D) as (D, E) f32 holding ``dtype``'s values: the JAX
    loader stores it in the compute dtype and the router reads it in f32."""
    return _dense(t, dtype, device, transpose=True).float()


def _row_slice(t: TensorInfo, r0: int, r1: int, name: str) -> TensorInfo:
    """Rows [r0, r1) of a 2-D GGUF tensor, its bytes as stored (JAX
    ``_row_slice``: quant blocks never straddle rows)."""
    blck, bsize = GGML_BLOCK_SIZES[t.ggml_type]
    K = t.shape[-1]
    data = np.asarray(t.data).reshape(t.shape[0], K // blck * bsize)[r0:r1]
    return TensorInfo(name=name, shape=(r1 - r0, K), ne=(K, r1 - r0),
                      ggml_type=t.ggml_type, offset=-1, data=data.reshape(-1))


def _f32_info(name: str, arr: np.ndarray) -> TensorInfo:
    raw = np.ascontiguousarray(arr.astype("<f4")).view(np.uint8)
    return TensorInfo(name=name, shape=tuple(arr.shape), ne=tuple(arr.shape[::-1]),
                      ggml_type=GGMLType.F32, offset=-1, data=raw)


def effective_tensors(reader, cfg: ModelConfig) -> dict:
    """The file's tensors with a fused ``attn_qkv.{weight,bias}`` split into
    ``attn_{q,k,v}`` (mpt / bloom), and an MoE layer's ``post_attention_norm``
    also named ``ffn_norm`` where the file has no ``ffn_norm`` (gpt-oss names
    its FFN pre-norm so; JAX ``effective_tensors``)."""
    src = dict(reader.tensors)
    Dq, Dkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    bounds = {"q": (0, Dq), "k": (Dq, Dq + Dkv), "v": (Dq + Dkv, Dq + 2 * Dkv)}
    for i in range(cfg.n_layers):
        b = f"blk.{i}."
        if (b + "ffn_norm.weight" not in src and b + "post_attention_norm.weight" in src
                and b + "ffn_gate_inp.weight" in src):
            src[b + "ffn_norm.weight"] = src[b + "post_attention_norm.weight"]
        w = src.get(b + "attn_qkv.weight")
        if w is not None and b + "attn_q.weight" not in src:
            for n, (r0, r1) in bounds.items():
                src[f"{b}attn_{n}.weight"] = _row_slice(w, r0, r1, f"{b}attn_{n}.weight")
        bias = src.get(b + "attn_qkv.bias")
        if bias is not None and b + "attn_q.bias" not in src:
            arr = bias.to_f32().reshape(-1)
            for n, (r0, r1) in bounds.items():
                src[f"{b}attn_{n}.bias"] = _f32_info(f"{b}attn_{n}.bias", arr[r0:r1])
    return src


def _layer_infos(t, cfg: ModelConfig) -> list[dict]:
    """Per layer, the GGUF tensor info of every known name the file has."""
    return [{k: t[f"blk.{i}.{n}"] for k, n in _LAYER_NAMES.items()
             if f"blk.{i}.{n}" in t} for i in range(cfg.n_layers)]


def _top_vectors(params, t, device) -> None:
    """The optional model-level f32 vectors the file has."""
    for key, name in _TOP_VECTORS.items():
        if name in t:
            params[key] = _dense(t[name], torch.float32, device)


def _pad_expert_biases(p: dict) -> dict:
    """The gate and up experts' biases (E, F) zero-padded to the experts'
    width, which the quantized loader pads to a multiple of 512: the pad
    lanes then carry g = u = 0, which every expert activation maps to 0.
    (The JAX loader pads the experts but not their biases, so its forward
    fails on a file whose expert FF is not a multiple of 512, such as
    gpt-oss-20b's 2880.)"""
    for b, w in (("moe_gate_b", "moe_gate"), ("moe_up_b", "moe_up")):
        if b in p and w in p and p[b].shape[-1] < p[w].shape[-1]:
            p[b] = torch.nn.functional.pad(p[b], (0, p[w].shape[-1] - p[b].shape[-1]))
    return p


def _put_layers(layers: list[dict], fuse: bool) -> nn.ModuleList:
    return nn.ModuleList(ParamDict(fuse_projections(_pad_expert_biases(p)) if fuse else p)
                         for p in layers)


def load_llama_params(reader, cfg: ModelConfig, dtype=torch.bfloat16,
                      device="cpu") -> ParamDict:
    """Dense load: every tensor dequantized to ``dtype`` (norms stay f32)."""
    t = effective_tensors(reader, cfg)
    emb = _dense(t[EMBD], dtype, device)
    params = ParamDict({
        "tok_emb": emb,
        "out_norm": _dense(t[OUT_NORM], torch.float32, device),
        "lm_head": (_dense(t[OUTPUT], dtype, device, transpose=True)
                    if OUTPUT in t else emb.T.contiguous()),
    })
    _top_vectors(params, t, device)
    layers = []
    for infos in _layer_infos(t, cfg):
        p = {}
        for key, info in infos.items():
            if key == "moe_gate_inp":
                p[key] = _router(info, dtype, device)
            elif key in _MATMUL or key in _EXPERTS or key == "shexp_gate_inp":
                p[key] = _dense(info, dtype, device, transpose=True)
            elif key in _VECTORS:
                p[key] = _dense(info, dtype, device)
            else:
                p[key] = _dense(info, torch.float32, device)
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
    ``dtype``.  q/k/v and gate/up are fused (:func:`fuse_projections`).
    Stacked experts keep plain f32 scale planes (:func:`pack_gguf_experts`;
    int8/g16 where their type differs across layers), decoded on the
    device one tensor at a time."""
    t = effective_tensors(reader, cfg)
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
    elif OUTPUT in t:
        params["lm_head"] = _dense(t[OUTPUT], dtype, device, True)
    else:  # tied: the embedding's values (decoded once), transposed
        params["lm_head"] = params["tok_emb"].T.contiguous()
    _top_vectors(params, t, device)

    names = _layer_infos(t, cfg)
    # one fold decision per model, over the 2-D projections only (stacked
    # experts never fold), as the JAX loader decides it
    fold = all(
        info.ggml_type in _SCALE_PART_DECODERS
        and _fold_streams(int(info.shape[-1]), info.ggml_type)
        for p in names for k, info in p.items()
        if k in _MATMUL and len(info.shape) == 2)
    # expert tensors of mixed types across layers unify to int8/g16, so
    # every layer keeps one layout (K6 streams one layout per launch)
    mixed = {k for k in _EXPERTS
             if len({p[k].ggml_type for p in names if k in p}) > 1}
    layers = []
    for p_infos in names:
        p = {}
        for key, info in p_infos.items():
            if key == "moe_gate_inp":
                p[key] = _router(info, dtype, device)
            elif key in _EXPERTS and quantizable(info):
                pack = pack_experts_int8_g16 if key in mixed else pack_gguf_experts
                p[key] = pack(info.data, info.ggml_type, info.shape,
                              device=device, **_EXPERTS[key])
            elif key in _MATMUL and quantizable(info):
                p[key] = pack_gguf_tensor(info.data, info.ggml_type, info.shape,
                                          fold_scales=fold, device=device)
            elif key in _MATMUL or key in _EXPERTS or key == "shexp_gate_inp":
                p[key] = _dense(info, dtype, device, transpose=True)
            elif key in _VECTORS:
                p[key] = _dense(info, dtype, device)
            else:
                p[key] = _dense(info, torch.float32, device)
        layers.append(p)
    params["layers"] = _put_layers(layers, fuse=True)
    return params


def repack_nib4c_to_int8(qt: QuantTensor) -> QuantTensor:
    """A nib4c tensor as int8 values (0..15) with the same scales and mins:
    every dequantized value bit-identical, twice the bytes (JAX
    ``repack_nib4_to_int8``)."""
    if qt.fmt != "nib4c":
        return qt
    return QuantTensor(values(qt.q, qt).contiguous(), qt.s, qt.m, "int8",
                       qt.group, qt.shape, qt.sd, qt.md, qt.sgroup)


def _concat(parts: list):
    """Concatenate weights along the output dim (one launch instead of
    several), or None when their layouts cannot meet (JAX
    ``_concat_weights``): nib4c parts beside int8 ones repack to int8
    (lossless); int8 groups harmonize to the finest by repeating the
    coarser parts' scale and min rows; a missing min plane is zeros."""
    if all(isinstance(p, torch.Tensor) for p in parts):
        return torch.cat(parts, -1)
    if not all(isinstance(p, QuantTensor) for p in parts):
        return None
    if any(p.q.shape[-1] != p.N for p in parts):
        return None
    fmts = {p.fmt for p in parts}
    if len(fmts) > 1 and fmts <= {"nib4c", "int8"} and len({p.K for p in parts}) == 1:
        parts = [repack_nib4c_to_int8(p) for p in parts]
    if len({(p.fmt, p.K) for p in parts}) != 1:
        return None
    folded = {p.sd is not None for p in parts}
    if len(folded) != 1 or len({p.sgroup for p in parts}) != 1:
        return None
    folded = folded.pop()
    g = min(p.group for p in parts)
    if any(p.group != g for p in parts):
        if parts[0].fmt != "int8" or any(p.group % g for p in parts):
            return None
        rep = lambda t, n: None if t is None else t.repeat_interleave(n, 0)  # noqa: E731
        parts = [QuantTensor(p.q, rep(p.s, p.group // g), rep(p.m, p.group // g), p.fmt,
                             g, p.shape, p.sd, p.md, p.sgroup) for p in parts]
    p0 = parts[0]
    m = md = None
    if any(p.m is not None for p in parts):
        m = torch.cat([p.m if p.m is not None else torch.zeros_like(p.s) for p in parts], -1)
        if folded:
            md = torch.cat([p.md if p.md is not None else torch.zeros_like(p.sd)
                            for p in parts], -1)
    return QuantTensor(torch.cat([p.q for p in parts], -1),
                       torch.cat([p.s for p in parts], -1), m, p0.fmt, g,
                       (p0.K, sum(p.N for p in parts)),
                       torch.cat([p.sd for p in parts], -1) if folded else None, md,
                       p0.sgroup)


def fuse_projections(p: dict) -> dict:
    """Fuse q/k/v -> ``wqkv_fused`` (or q|k -> ``wqk_fused`` with v apart
    when q/k are nib4c and v int8, the Q4_K_M split-v disposition, unless
    the layer has biases: qwen2 keeps the full fuse, repacking q/k to int8,
    and its biases fuse into ``bqkv_fused``), gate/up -> ``wgateup_fused``
    and the shared expert's gate/up -> ``shexp_gateup_fused``."""
    out = dict(p)
    wq, wk, wv = p["wq"], p["wk"], p["wv"]
    qk_only = (all(isinstance(w, QuantTensor) for w in (wq, wk, wv))
               and wq.fmt == wk.fmt == "nib4c" and wv.fmt == "int8" and "bq" not in p)
    keys = ("wq", "wk") if qk_only else ("wq", "wk", "wv")
    fused = _concat([p[k] for k in keys])
    if fused is not None:
        out["wqk_fused" if qk_only else "wqkv_fused"] = fused
        for k in keys:
            del out[k]
        if not qk_only and all(k in p for k in _BIASES):
            out["bqkv_fused"] = torch.cat([p[k] for k in _BIASES], -1)
            for k in _BIASES:
                del out[k]
    if "w_gate" in p and "w_up" in p:  # an MoE layer has neither
        fused = _concat([p["w_gate"], p["w_up"]])
        if fused is not None:
            out["wgateup_fused"] = fused
            del out["w_gate"], out["w_up"]
    if "shexp_gate" in p and "shexp_up" in p:
        fused = _concat([p["shexp_gate"], p["shexp_up"]])
        if fused is not None:
            out["shexp_gateup_fused"] = fused
            del out["shexp_gate"], out["shexp_up"]
    return out


def _router_rows(p) -> torch.Tensor:
    """The layer's router (D, E) f32, zero-padded to a power-of-two width
    for K6 (the kernel masks the pad lanes)."""
    gi = p["moe_gate_inp"]
    if gi.dtype != torch.float32:
        raise ValueError("decode table: moe_gate_inp must be float32")
    E = gi.shape[1]
    Ep = 1 << (E - 1).bit_length()
    return gi if Ep == E else torch.nn.functional.pad(gi, (0, Ep - E)).contiguous()


def _norm_vec(p, n: str):
    """Layer p's f32 norm vector ``n``, or None where the layer has none."""
    if n not in p:
        return None
    if p[n].dtype != torch.float32:
        raise ValueError(f"decode table: {n} must be float32")
    return p[n]


def layer_table(params: ParamDict, cfg: ModelConfig) -> torch.Tensor:
    """The decode kernels' (K6, K7) view of the layer stack: an int64 device
    table (L, 50) of, per layer, the addresses of the q, s, m, sd, md planes
    of the projections q|k|v (or q|k), v (split-v only), o, gate|up and down
    (an MoE layer's shared expert's gate|up and down in those two slots; 0
    where a plane is absent), then the attn_norm and ffn_norm vectors and
    the layer's sliding window (0 on a global layer); an MoE layer adds its
    router (D, Ep) f32 and, for the stacked experts gate, up and down, the
    q, s, m base addresses and the byte strides of one expert's q and s (m)
    planes, so expert e lies at base + e * stride (0 for a dense layer);
    last, the addresses of the gemma norms q_norm, k_norm, post_attn_norm
    and post_ffn_norm (0 where absent), the layer's SWA flag and the shared
    expert's gate vector (an f32 copy, D; 0 where absent).  The JAX
    package stacks the layers instead; the port builds this once, holds it
    with the params (whose tensors it points into) and reuses it every
    step.  Planes must be contiguous, 16-byte aligned and on one device;
    otherwise this raises."""
    cached = params.__dict__.get("_layer_table")
    if cached is not None:
        return cached
    from ..ops.decode_stream import EXPERT_KEYS, GEMMA_NORMS, proj_keys

    layers = params["layers"]
    keys = proj_keys(layers[0])
    dense = [k for k in keys if k not in EXPERT_KEYS]
    slots = dense if dense[0] == "wqk_fused" else [dense[0], None] + dense[1:]
    slots += [None] * (5 - len(slots))  # an MoE layer has no dense FFN
    dev = layers[0]["attn_norm"].device
    routers, gates = [], []

    def addr(t, align: int) -> int:
        if t is None:
            return 0
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError("decode table: planes must be contiguous, "
                             f"{align}-byte aligned and on {dev}")
        return t.data_ptr()

    rows = []
    for li, p in enumerate(layers):
        row = []
        for k in slots:
            qt = p[k] if k else None
            row += [addr(getattr(qt, n) if qt else None, 16)
                    for n in ("q", "s", "m", "sd", "md")]
        for n in ("attn_norm", "ffn_norm"):
            row.append(addr(_norm_vec(p, n), 4))
        row.append(cfg.layer_windows[li])
        if "moe_gate_inp" in p:
            routers.append(_router_rows(p))
            row.append(addr(routers[-1], 16))
            for k in EXPERT_KEYS:
                qt = p[k]
                row += [addr(getattr(qt, n), 16) for n in ("q", "s", "m")]
                row += [qt.q[0].nbytes, qt.s[0].nbytes]
        else:
            row += [0] * 16
        row += [addr(_norm_vec(p, n), 4) for n in GEMMA_NORMS]
        row.append(int(cfg.swa_layers[li]))
        if "shexp_gate_inp" in p:
            gates.append(p["shexp_gate_inp"].float().reshape(-1).contiguous())
            row.append(addr(gates[-1], 16))
        else:
            row.append(0)
        rows.append(row)
    table = torch.tensor(rows, dtype=torch.int64).to(dev)
    params.__dict__["_layer_table"] = table
    params.__dict__["_router_rows"] = routers  # the padded routers it points into
    params.__dict__["_shexp_gates"] = gates  # the f32 gate vectors it points into
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
    keeping dtypes and byte layout (stacked experts (L, E, ...) become
    (E, ...) per layer)."""

    def conv(v, i=None):
        if hasattr(v, "fmt"):  # the JAX package's QuantTensor
            take = (lambda a: None if a is None else
                    _to_torch(a if i is None else a[i], device))
            return QuantTensor(take(v.q), take(v.s), take(v.m), v.fmt, v.group,
                               v.shape, take(v.sd), take(v.md), v.sgroup or 0)
        return _to_torch(v if i is None else v[i], device)

    def conv_layer(i):
        p = {k: conv(v, i) for k, v in np_params["layers"].items()}
        if "moe_gate_inp" in p:  # the port's router is f32 (same values)
            p["moe_gate_inp"] = p["moe_gate_inp"].float()
        return ParamDict(_pad_expert_biases(p))

    params = ParamDict({k: conv(np_params[k])
                        for k in ("tok_emb", "out_norm", "lm_head", *_TOP_VECTORS)
                        if k in np_params})
    params["layers"] = nn.ModuleList(conv_layer(i) for i in range(cfg.n_layers))
    return params
