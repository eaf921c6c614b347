"""K6: single-token decode through the whole layer stack in one launch.

Port of ``llama_cpp_gfx906_tpu/ops/decode_stream.py`` for the dense llama
modes: the gate (:func:`_stream_ok`), the entry point
(:func:`fused_decode_step_streamed`) and its plain version
(:func:`fused_decode_step_streamed_plain`).  The kernel is
``csrc/decode_stream.cu`` (see its header for the design); K7
(``ops/decode_step.py``) is an instantiation of the same source, and both
entry points share the launch and the plain layer math defined here.

Contract (as the JAX kernel): ``x`` (B, 1, D) is the embedded token of each
of B <= 8 slots; the result is x after every layer (B, 1, D) in x's dtype;
each slot's new K/V row is written at its ``n_past`` in ``kv`` in place,
and ``n_past`` is left for the caller to advance.

The gate accepts and rejects what the JAX gate does for the configurations
the port can express (plain llama: no qk-norm, post-norms, dual rope bases,
gelu or MoE; those modes and the MoE leg are not ported yet and are
refused), with two additions that follow from per-layer parameters: a
projection must have one format, group and super-group across all layers,
and the cache must be bf16 or f32 (the JAX kernel's own scope).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import kernels
from .quant_matmul import QuantTensor, _gemv_segment, _unpack_nib4c
from .rope import inv_freq_for, rope_frequencies

NEG_INF = -1e30

_TK_CAPS = (1024, 512, 256)
_TN_CAPS = (1024, 512, 256, 128)


def _pick(caps, dim, mult=1):
    return next((t for t in caps if dim % t == 0 and t % mult == 0), None)


def _proj_tk(K: int, g: int, is_n4: bool):
    """The JAX kernel's K chunk of one projection, or None when the
    projection does not factor into its chunk grid."""
    if is_n4:
        from .quant_matmul import nib4c_chunk

        tk = nib4c_chunk(K)
        if tk is None or tk % (16 * g):
            return None
        return tk
    return _pick(_TK_CAPS, K, mult=8 * g)


def _stream_qt(t) -> bool:
    """Gate one projection: int8 or nib4c, unpadded, mins shaped like the
    scales, folded super-scales on a chunk-aligned grid."""
    if not (isinstance(t, QuantTensor) and t.fmt in ("int8", "nib4c")
            and t.q.ndim == 2 and t.q.shape[-1] == t.shape[1]
            and (t.m is None or t.m.shape == t.s.shape)):
        return False
    is_n4 = t.fmt == "nib4c"
    K = t.shape[0]
    TK = _proj_tk(K, t.group, is_n4)
    if TK is None:
        return False
    if t.sd is not None:
        if t.sgroup <= 0 or t.sgroup % t.group or K % t.sgroup:
            return False
        if (t.m is None) != (t.md is None):
            return False
        if TK != K and (TK // t.sgroup) % 8 != 0:
            return False
    return True


def _layout(qt) -> tuple:
    return (qt.fmt, qt.group, qt.sgroup, qt.shape, qt.m is not None,
            qt.sd is not None)


def proj_keys(layer) -> tuple[str, ...]:
    """The projections in kernel order: q|k|v (or q|k), [v], o, gate|up,
    down."""
    if "wqk_fused" in layer and "wv" in layer and "wqkv_fused" not in layer:
        return ("wqk_fused", "wv", "wo", "wgateup_fused", "w_down")
    return ("wqkv_fused", "wo", "wgateup_fused", "w_down")


def uniform_layers(layers, keys) -> bool:
    """Every layer holds exactly ``keys`` (plus the norms), each projection
    with one layout across the layers."""
    want = set(keys) | {"attn_norm", "ffn_norm"}
    if any(set(p.keys()) != want for p in layers):
        return False
    return all(len({_layout(p[k]) for p in layers}) == 1
               for k in keys if isinstance(layers[0][k], QuantTensor))


def _stream_ok(params, cfg, kv, B: int, T: int) -> bool:
    """The K6 gate (B <= 8 slots, T = 1, every projection in the streamed
    chunk grid)."""
    if T != 1 or not (1 <= B <= 8):
        return False
    if kv.k.ndim != 5 or kv.k.shape[1] != B:
        return False
    if kv.k.dtype not in (torch.bfloat16, torch.float32):
        return False
    layers = params["layers"]
    p = layers[0]
    split_v = "wqk_fused" in p and "wv" in p and "wqkv_fused" not in p
    qkv_key = "wqk_fused" if split_v else "wqkv_fused"
    keys = proj_keys(p)
    if not all(k in p for k in keys + ("attn_norm", "ffn_norm")):
        return False
    if not uniform_layers(layers, keys):
        return False
    if not all(_stream_qt(p[k]) for k in keys):
        return False
    if len({p[k].sd is not None for k in keys}) != 1:
        return False  # mixed folded/plain scale layouts across projections
    if p[qkv_key].sd is not None and len({p[k].sgroup for k in keys}) != 1:
        return False  # one shared super-group per launch
    D, Dh, F_ = cfg.n_embd, cfg.head_dim, cfg.n_ff
    S = kv.k.shape[2]
    if not (D % 128 == 0 and Dh % 128 == 0 and F_ % 128 == 0 and S % 128 == 0):
        return False
    if 2 * len(rope_frequencies(cfg)) != Dh:
        return False  # partial rope
    if split_v:
        if p["wqk_fused"].shape != (D, (cfg.n_heads + cfg.n_kv_heads) * Dh):
            return False
        if p["wv"].shape != (D, cfg.n_kv_heads * Dh):
            return False
    elif p["wqkv_fused"].shape != (D, (cfg.n_heads + 2 * cfg.n_kv_heads) * Dh):
        return False
    if p["wgateup_fused"].shape != (D, 2 * F_):
        return False
    for k in keys:
        K, N = p[k].shape
        if (_pick(_TN_CAPS, N) is None
                or _proj_tk(K, p[k].group, p[k].fmt == "nib4c") is None):
            return False
    return True


# ---------------------------------------------------------------------------
# plain version: the layer math with the kernel's rounding points
# ---------------------------------------------------------------------------


def _bf16r(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _scale_planes(qt: QuantTensor):
    """(scales f32 (K/g, N), mins f32 (K/g, N) or None), folds applied."""
    s, m = qt.s.float(), None if qt.m is None else qt.m.float()
    if qt.sd is not None:
        rep = qt.sgroup // qt.group
        s = s * qt.sd.repeat_interleave(rep, 0)
        if m is not None:
            m = m * qt.md.repeat_interleave(rep, 0)
    return s, m


def qlinear_plain(xb: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """xb (B, K) f32 @ qt -> (B, N) f32 as the kernel computes it: q * scale
    as an f32 product (rounded to bf16 for int8 weights), f32 sums, mins as
    (per-group sum of x) * m."""
    s, m = _scale_planes(qt)
    vals = _unpack_nib4c(qt.q, qt.K) if qt.fmt == "nib4c" else qt.q
    w = vals.float() * s.repeat_interleave(qt.group, 0)
    if qt.fmt == "int8":
        w = _bf16r(w)
    y = xb @ w
    if m is not None:
        y = y - xb.reshape(xb.shape[0], -1, qt.group).sum(-1) @ m
    return y[:, : qt.N]


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def _rope_rows(cfg, n_past: torch.Tensor):
    """Lane-expanded (B, Dh) cos and signed-sin rows at each slot's n_past."""
    inv = inv_freq_for(cfg, n_past.device)
    ang = n_past.float()[:, None] * inv
    c, s = torch.cos(ang), torch.sin(ang)
    if cfg.rope_interleaved:
        sign = torch.ones(cfg.head_dim, device=n_past.device)
        sign[0::2] = -1.0
        return c.repeat_interleave(2, -1), s.repeat_interleave(2, -1) * sign
    return torch.cat([c, c], -1), torch.cat([-s, s], -1)


def _rotate(v: torch.Tensor, C, Ss, interleaved: bool) -> torch.Tensor:
    """v (B, H, Dh) * C + partner(v) * Ss, the JAX kernel's rope1."""
    if interleaved:
        partner = v.reshape(*v.shape[:-1], -1, 2).flip(-1).reshape(v.shape)
    else:
        partner = torch.roll(v, v.shape[-1] // 2, -1)
    return v * C[:, None] + partner * Ss[:, None]


def decode_layers_plain(params, cfg, x: torch.Tensor, kv) -> torch.Tensor:
    """The plain version shared by K6 and K7: x (B, 1, D) -> (B, 1, D) in
    x's dtype, the new K/V rows written at n_past in place."""
    layers = params["layers"]
    keys = proj_keys(layers[0])
    split_v = keys[0] == "wqk_fused"
    B, D = x.shape[0], cfg.n_embd
    Hq, Hkv, Dh, F_ = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_ff
    G, Dq, HD = Hq // Hkv, Hq * Dh, Hkv * Dh
    S = kv.k.shape[2]
    scale = cfg.attn_scale or Dh ** -0.5
    window = cfg.sliding_window
    dev = x.device
    n_past = kv.n_past.long()
    C, Ss = _rope_rows(cfg, kv.n_past)
    rows = torch.arange(S, device=dev)[None, :]
    lo = (n_past - window + 1).clamp(min=0) if window > 0 else torch.zeros_like(n_past)
    live = (rows >= lo[:, None]) & (rows < n_past[:, None])  # (B, S)
    bidx = torch.arange(B, device=dev)
    eps = cfg.rms_eps

    xc = x.reshape(B, D).float()
    for li, p in enumerate(layers):
        h = _bf16r(_rms(xc, p["attn_norm"], eps))
        qkv = qlinear_plain(h, p[keys[0]])
        if split_v:
            qkv = torch.cat([qkv, qlinear_plain(h, p["wv"])], -1)
        qkv = _bf16r(qkv)
        q = _rotate(qkv[:, :Dq].reshape(B, Hq, Dh), C, Ss, cfg.rope_interleaved)
        k = _rotate(qkv[:, Dq:Dq + HD].reshape(B, Hkv, Dh), C, Ss,
                    cfg.rope_interleaved)
        v = qkv[:, Dq + HD:].reshape(B, Hkv, Dh)
        qb = _bf16r(q).reshape(B, Hkv, G, Dh)
        kb = _bf16r(k)

        kc, vc = kv.k[li], kv.v[li]  # (B, S, Hkv, Dh)
        sc = torch.einsum("bhgd,bshd->bhgs", qb, kc.float()) * scale
        sc = torch.where(live[:, None, None], sc, NEG_INF)
        s_self = (qb * kb[:, :, None]).sum(-1) * scale  # (B, Hkv, G)
        m = torch.maximum(sc.amax(-1), s_self)
        p_ = torch.exp(sc - m[..., None])
        p_self = torch.exp(s_self - m)
        den = p_.sum(-1) + p_self
        o = torch.einsum("bhgs,bshd->bhgd", _bf16r(p_), vc.float())
        o = (o + p_self[..., None] * v[:, :, None]) / den[..., None]
        # the new rows at n_past (a slot already at S writes nothing)
        row, ins = n_past.clamp(max=S - 1), (n_past < S)[:, None, None]
        kc[bidx, row] = torch.where(ins, k.to(kc.dtype), kc[bidx, row])
        vc[bidx, row] = torch.where(ins, v.to(vc.dtype), vc[bidx, row])

        attn = qlinear_plain(_bf16r(o.reshape(B, Dq)), p["wo"])
        xc = _bf16r(_bf16r(xc) + _bf16r(attn))
        h2 = _bf16r(_rms(xc, p["ffn_norm"], eps))
        gu = qlinear_plain(h2, p["wgateup_fused"])
        g, u = _bf16r(gu[:, :F_]), _bf16r(gu[:, F_:])
        y = _bf16r(_bf16r(F.silu(g)) * u)
        xc = _bf16r(_bf16r(xc) + _bf16r(qlinear_plain(y, p["w_down"])))
    return xc.to(x.dtype).reshape(B, 1, D)


# ---------------------------------------------------------------------------
# the launch (K6 and K7)
# ---------------------------------------------------------------------------

MAX_G = 16          # query heads per KV head the kernel takes
MAX_QDIM = 4096     # G * Dh
MAX_SPLIT = 32      # key-range splits per (slot, KV head)
TABLE_W = 28        # int64 words per layer in the plane table


class ProjDims(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in
                ("K", "N", "group", "sgroup", "ck", "seg", "nib")]


class DecodeArgs(ctypes.Structure):
    """Mirrors ``DecodeArgs`` in ``csrc/decode_stream.cu``."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "table", "kc", "vc", "n_past", "inv_freq", "x0", "xin", "xmid",
        "xout", "qkv_acc", "o_acc", "gu_acc", "dn_acc", "obuf", "part",
        "selfs", "bar")]
        + [("proj", ProjDims * 5)]
        + [(n, ctypes.c_int) for n in (
            "L", "B", "D", "Hq", "Hkv", "Dh", "F", "S", "nsplit", "split_v",
            "interleaved")]
        + [("scale", ctypes.c_float), ("eps", ctypes.c_float)])


class _Workspace:
    """Scratch of one (params, B, S, cache dtype, kernel): allocated once
    and reused by every step, so a step allocates nothing of its own."""

    def __init__(self, cfg, mp: int, B: int, Nqkv: int, dev):
        D, F_, Dh = cfg.n_embd, cfg.n_ff, cfg.head_dim
        G = cfg.n_heads // cfg.n_kv_heads
        f32 = dict(dtype=torch.float32, device=dev)
        self.acc = torch.zeros(mp * (Nqkv + D + 2 * F_ + D), **f32)
        self.qkv_acc, self.o_acc, self.gu_acc, self.dn_acc = torch.split(
            self.acc, [mp * Nqkv, mp * D, mp * 2 * F_, mp * D])
        self.x0 = torch.zeros((mp, D), **f32)
        self.xin = torch.zeros((mp, D), **f32)
        self.xmid = torch.zeros((mp, D), **f32)
        self.xout = torch.zeros((mp, D), **f32)
        self.obuf = torch.zeros((mp, cfg.n_heads * Dh), **f32)
        self.part = torch.zeros(
            B * cfg.n_kv_heads * MAX_SPLIT * G * (Dh + 2), **f32)
        self.selfs = torch.zeros((B, cfg.n_heads), **f32)
        self.bar = torch.zeros(2, dtype=torch.int32, device=dev)


def _so():
    so = kernels.lib("decode_stream")
    if so.lcg_decode_stream.argtypes is None:
        so.lcg_decode_stream.restype = ctypes.c_int
        so.lcg_decode_stream.argtypes = [
            ctypes.POINTER(DecodeArgs), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        so.lcg_decode_step.restype = ctypes.c_int
        so.lcg_decode_step.argtypes = [
            ctypes.POINTER(DecodeArgs), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    return so


def _call(so, k7: bool, args, mp: int, folded: bool, kv_bf16: bool,
          query_only: bool, dev) -> int:
    grid = ctypes.c_int(0)
    if k7:
        err = so.lcg_decode_step(ctypes.byref(args), int(kv_bf16),
                                 int(query_only), ctypes.byref(grid),
                                 kernels.stream(dev))
    else:
        err = so.lcg_decode_stream(ctypes.byref(args), mp, int(folded),
                                   int(kv_bf16), int(query_only),
                                   ctypes.byref(grid), kernels.stream(dev))
    kernels.check(so, err, "decode_step" if k7 else "decode_stream")
    return grid.value


def launch_decode(params, cfg, x: torch.Tensor, kv, k7: bool) -> torch.Tensor:
    """Run the K6 (or, with ``k7``, the K7) instantiation once."""
    from ..runtime.weights import layer_table

    layers = params["layers"]
    keys = proj_keys(layers[0])
    split_v = keys[0] == "wqk_fused"
    B, D = x.shape[0], cfg.n_embd
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = Hq // Hkv
    if G > MAX_G or G * Dh > MAX_QDIM or Dh % 128 or Dh > 512 or B > 8:
        raise ValueError(f"decode kernel: G={G}, Dh={Dh}, B={B} out of range")
    if not (kv.k.is_contiguous() and kv.v.is_contiguous()) or \
            kv.k.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("decode kernel: the cache must be contiguous bf16/f32")
    dev = x.device
    mp = next(p for p in (1, 2, 4, 8) if p >= B)
    qts = [layers[0][k] for k in keys]
    folded = qts[0].sd is not None
    Nqkv = Hq * Dh + 2 * Hkv * Dh
    wkey = (B, kv.k.shape[2], kv.k.dtype, k7)
    spaces = params.__dict__.setdefault("_decode_workspaces", {})
    ws = spaces.get(wkey)
    if ws is None:
        ws = spaces[wkey] = _Workspace(cfg, mp, B, Nqkv, dev)

    args = DecodeArgs()
    for name, t in (("table", layer_table(params, cfg)), ("kc", kv.k),
                    ("vc", kv.v), ("n_past", kv.n_past),
                    ("inv_freq", inv_freq_for(cfg, dev)), ("x0", ws.x0),
                    ("xin", ws.xin), ("xmid", ws.xmid), ("xout", ws.xout),
                    ("qkv_acc", ws.qkv_acc), ("o_acc", ws.o_acc),
                    ("gu_acc", ws.gu_acc), ("dn_acc", ws.dn_acc),
                    ("obuf", ws.obuf), ("part", ws.part), ("selfs", ws.selfs),
                    ("bar", ws.bar)):
        setattr(args, name, t.data_ptr())
    slots = (0, 1, 2, 3, 4) if split_v else (0, 2, 3, 4)
    for slot, qt in zip(slots, qts):
        seg, ck = _gemv_segment(qt)
        args.proj[slot] = ProjDims(qt.K, qt.N, qt.group, qt.sgroup or 1, ck,
                                   seg, int(qt.fmt == "nib4c"))
    args.L, args.B, args.D = cfg.n_layers, B, D
    args.Hq, args.Hkv, args.Dh, args.F = Hq, Hkv, Dh, cfg.n_ff
    args.S = kv.k.shape[2]
    args.split_v, args.interleaved = int(split_v), int(cfg.rope_interleaved)
    args.scale = float(cfg.attn_scale or Dh ** -0.5)
    args.eps = float(cfg.rms_eps)

    so = _so()
    kv_bf16 = kv.k.dtype == torch.bfloat16
    gkey = (k7, mp, folded, kv_bf16)
    grids = params.__dict__.setdefault("_decode_grids", {})
    if gkey not in grids:
        grids[gkey] = _call(so, k7, args, mp, folded, kv_bf16, True, dev)
    args.nsplit = max(1, min(MAX_SPLIT, grids[gkey] // (B * Hkv)))
    if kv.n_past.dtype != torch.int32 or kv.n_past.device != dev:
        raise ValueError("decode kernel: n_past must be int32 on the card")
    ws.x0[:B].copy_(x.reshape(B, D))
    ws.acc.zero_()
    _call(so, k7, args, mp, folded, kv_bf16, False, dev)
    return ws.xout[:B].to(x.dtype, copy=True).reshape(B, 1, D)


@kernels.counted("decode_stream")
def fused_decode_step_streamed(params, cfg, x: torch.Tensor, kv) -> torch.Tensor:
    """K6: x (B, 1, D) through every layer, the KV updated in place (see the
    module docstring).  On the CPU, the plain version."""
    if x.device.type == "cpu":
        return fused_decode_step_streamed_plain(params, cfg, x, kv)
    out = launch_decode(params, cfg, x, kv, k7=False)
    fused_decode_step_streamed.launches += 1
    return out


def fused_decode_step_streamed_plain(params, cfg, x, kv) -> torch.Tensor:
    """Plain version of K6 (the same contract)."""
    return decode_layers_plain(params, cfg, x, kv)
