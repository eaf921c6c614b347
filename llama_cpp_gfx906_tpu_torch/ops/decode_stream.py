"""K6: single-token decode through the whole layer stack in one launch.

Port of ``llama_cpp_gfx906_tpu/ops/decode_stream.py`` for the llama modes,
dense and MoE, and the gemma modes (gemma3, and qwen3's qk-norm): the gates
(:func:`_stream_ok`, :func:`_moe_stream_ok`), the entry point
(:func:`fused_decode_step_streamed`) and its plain version
(:func:`fused_decode_step_streamed_plain`).  The kernel is
``csrc/decode_stream.cu`` (see its header for the design); K7
(``ops/decode_step.py``) is an instantiation of the same source, and both
entry points share the launch and the plain layer math defined here.
An MoE layer (Mixtral, qwen3moe) routes inside the kernel: router, top-k
and the reads of only the chosen experts' slices (B = 1, as the JAX
kernel), plus an always-on shared expert with an optional sigmoid gate
where the layer has one (a bias-free qwen2moe).  The gemma modes
(:func:`gemma_mode`) run the kernel's gemma instantiation: per-head q/k RMS
norms before rope, the rope table of each layer chosen by its SWA flag
(local base, unscaled, or the global one), the post-attention and post-FFN
norms before the residual adds, and gelu in the FFN; each is a runtime
flag, so qwen3 (qk-norm alone) and qwen3moe (qk-norm and MoE) run it too.

Contract (as the JAX kernel): ``x`` (B, 1, D) is the embedded token of each
of B <= 8 slots; the result is x after every layer (B, 1, D) in x's dtype;
each slot's new K/V row is written at its ``n_past`` in ``kv`` in place,
and ``n_past`` is left for the caller to advance.

The gate accepts and rejects what the JAX gate does for the configurations
the port can express (llama, gemma3 and the qwen families: q/k/v biases
are refused, as the JAX gate refuses ``bqkv_fused``, and so is an unfused
shared expert), with additions that follow from per-layer parameters or
the kernel's instantiations: a projection must have one format, group and
super-group across all layers, the cache must be bf16 or f32 (the JAX
kernel's own scope), an MoE model needs at most 256 experts and a model
dim of at most 8192 (the router stages h2 in shared memory), and a shared
expert's gate vector must hold D values.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import kernels
from .quant_matmul import QuantTensor, _gemv_segment, values
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
    return (qt.fmt, qt.group, qt.sgroup, qt.shape, tuple(qt.q.shape),
            qt.m is not None, qt.sd is not None)


EXPERT_KEYS = ("moe_gate", "moe_up", "moe_down")  # stacked experts, K6 order
SHEXP_KEYS = ("shexp_gateup_fused", "shexp_down")  # the shared expert (qwen2moe)
# gemma3's per-layer norm vectors, in the plane table's order
GEMMA_NORMS = ("q_norm", "k_norm", "post_attn_norm", "post_ffn_norm")
MAX_EXPERTS = 256   # router lanes the kernel takes
MAX_MOE_D = 8192    # model dim whose h2 the kernel stages for the router


def proj_keys(layer) -> tuple[str, ...]:
    """The projections in kernel order: q|k|v (or q|k), [v], o, then
    gate|up and down, or an MoE layer's shared expert's gate|up and down
    (where it has one) and its stacked experts gate, up, down."""
    split = "wqk_fused" in layer and "wv" in layer and "wqkv_fused" not in layer
    attn = ("wqk_fused", "wv", "wo") if split else ("wqkv_fused", "wo")
    if "moe_gate_inp" in layer:
        return attn + (SHEXP_KEYS if SHEXP_KEYS[0] in layer else ()) + EXPERT_KEYS
    return attn + ("wgateup_fused", "w_down")


def uniform_layers(layers, keys) -> bool:
    """Every layer holds exactly ``keys`` (plus the norms, gemma's among
    them, and an MoE layer's router), each projection with one layout and
    each extra tensor with one shape across the layers."""
    extra = {k for k in ("moe_gate_inp", "shexp_gate_inp") + GEMMA_NORMS
             if k in layers[0]}
    want = set(keys) | {"attn_norm", "ffn_norm"} | extra
    if any(set(p.keys()) != want for p in layers):
        return False
    if any(len({tuple(p[k].shape) for p in layers}) != 1 for k in extra):
        return False
    return all(len({_layout(p[k]) for p in layers}) == 1
               for k in keys if isinstance(layers[0][k], QuantTensor))


ACTS = {"silu": 0, "gelu": 1, "gelu_tanh": 1, "gelu_erf": 2}  # the kernel's act


def graph_ok(cfg, kv) -> bool:
    """The clauses of the JAX gates (K7 ``_fused_ok``, K6 ``_stream_ok``) on
    the model's graph and the cache: RMS norms, rope, a gated FFN, no ALiBi
    (mpt, bloom), no self-extend logical positions in the cache."""
    return (kv.pos is None and cfg.norm_type == "rms" and cfg.pos_emb == "rope"
            and not cfg.alibi and cfg.ffn_gated)


def gemma_ok(p, cfg) -> bool:
    """The gemma clauses of the JAX gates (K7 ``_fused_ok``, K6
    ``_stream_ok``): per-head q/k norms of shape (Dh,), post-norms only as
    a pair, an SWA model with a window, no attention softcap, and an
    activation the kernel has."""
    if cfg.qk_norm:
        if not all(k in p and p[k].ndim == 1 and p[k].shape[0] == cfg.head_dim
                   for k in ("q_norm", "k_norm")):
            return False
    elif "q_norm" in p or "k_norm" in p:
        return False
    if cfg.post_attn_norm or cfg.post_ffn_norm:
        if not ("post_attn_norm" in p and "post_ffn_norm" in p
                and cfg.post_attn_norm and cfg.post_ffn_norm):
            return False
    elif "post_attn_norm" in p or "post_ffn_norm" in p:
        return False
    if any(cfg.swa_layers) and cfg.sliding_window <= 0:
        return False
    return cfg.attn_logit_softcap <= 0 and cfg.act_fn in ACTS


def gemma_mode(cfg) -> bool:
    """Whether a stack runs the kernels' gemma instantiation: any of qk-norm,
    post-norms, a second rope base or an activation other than SiLU."""
    return bool(cfg.qk_norm or cfg.post_attn_norm or cfg.rope_local_base > 0
                or cfg.act_fn != "silu")


def _moe_stream_ok(p, cfg) -> bool:
    """MoE leg of the K6 gate (JAX ``_moe_stream_ok``): softmax or sigmoid
    routing over all experts, top-k of at most 8, optional renorm and
    scale; no router or expert biases; a shared expert only fused (gate|up
    and down, with an optional (D,) gate vector); stacked int8 or nib4c
    experts with plain scales on the chunk grid."""
    if not (cfg.n_experts > 0 and 1 <= cfg.n_experts_used <= 8):
        return False
    if cfg.moe_topk_softmax or cfg.moe_scale_input:
        return False  # gpt-oss / llama4 routing variants
    if cfg.expert_gating_func not in (1, 2):
        return False
    if any(k in p for k in ("moe_gate_inp_b", "moe_gate_b", "moe_up_b",
                            "moe_down_b", "moe_probs_bias", "exp_probs_b")):
        return False
    if (SHEXP_KEYS[0] in p) != (SHEXP_KEYS[1] in p):
        return False
    if "shexp_gate" in p or "shexp_up" in p:
        return False  # an unfused shared expert
    if "shexp_gate_inp" in p and p["shexp_gate_inp"].numel() != cfg.n_embd:
        return False
    gi = p["moe_gate_inp"]
    if not (isinstance(gi, torch.Tensor) and gi.ndim == 2
            and tuple(gi.shape) == (cfg.n_embd, cfg.n_experts)):
        return False
    if cfg.n_experts > MAX_EXPERTS or cfg.n_embd > MAX_MOE_D:
        return False
    for k in EXPERT_KEYS:
        t = p[k] if k in p else None
        if not (isinstance(t, QuantTensor) and t.fmt in ("int8", "nib4c")
                and t.sd is None and t.q.ndim == 3
                and t.q.shape[0] == cfg.n_experts and t.q.shape[-1] == t.shape[1]
                and (t.m is None or t.m.shape == t.s.shape)):
            return False
        K, N = t.shape
        if (_pick(_TN_CAPS, N) is None
                or _proj_tk(K, t.group, t.fmt == "nib4c") is None):
            return False
    return (p["moe_gate"].shape == p["moe_up"].shape
            and p["moe_down"].shape == p["moe_gate"].shape[::-1])


def _stream_ok(params, cfg, kv, B: int, T: int) -> bool:
    """The K6 gate (B <= 8 slots, T = 1, every projection in the streamed
    chunk grid)."""
    if T != 1 or not (1 <= B <= 8) or not graph_ok(cfg, kv):
        return False
    # a q8 cache or a shared-prefix segment: the JAX gate refuses both first
    if kv.shared_k is not None or not isinstance(kv.k, torch.Tensor):
        return False
    if not (kv.k.is_contiguous() and kv.v.is_contiguous()):
        return False  # a slot's view of a batched cache
    if kv.k.ndim != 5 or kv.k.shape[1] != B:
        return False
    if kv.k.dtype not in (torch.bfloat16, torch.float32):
        return False
    layers = params["layers"]
    p = layers[0]
    split_v = "wqk_fused" in p and "wv" in p and "wqkv_fused" not in p
    qkv_key = "wqk_fused" if split_v else "wqkv_fused"
    moe = "moe_gate_inp" in p
    if moe and (B != 1 or not _moe_stream_ok(p, cfg)):
        return False  # the kernel routes one token's experts
    if not gemma_ok(p, cfg):
        return False
    keys = proj_keys(p)
    if not all(k in p for k in keys + ("attn_norm", "ffn_norm")):
        return False
    if not uniform_layers(layers, keys):
        return False
    keys = tuple(k for k in keys if k not in EXPERT_KEYS)  # the dense ones
    if moe and SHEXP_KEYS[0] in p and (
            p[SHEXP_KEYS[0]].shape[1] != 2 * p[SHEXP_KEYS[1]].shape[0]
            or p[SHEXP_KEYS[1]].shape[1] != cfg.n_embd):
        return False
    if not all(_stream_qt(p[k]) for k in keys):
        return False
    if len({p[k].sd is not None for k in keys}) != 1:
        return False  # mixed folded/plain scale layouts across projections
    if p[qkv_key].sd is not None and len({p[k].sgroup for k in keys}) != 1:
        return False  # one shared super-group per launch
    D, Dh, F_ = cfg.n_embd, cfg.head_dim, cfg.n_ff
    if moe:
        F_ = 128  # no dense FFN; the experts' grid is checked above
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
    if not moe and p["wgateup_fused"].shape != (D, 2 * F_):
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
    vals = values(qt.q, qt)
    w = vals.float() * s.repeat_interleave(qt.group, 0)
    if qt.fmt == "int8":
        w = _bf16r(w)
    y = xb @ w
    if m is not None:
        y = y - xb.reshape(xb.shape[0], -1, qt.group).sum(-1) @ m
    return y[:, : qt.N]


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def _rope_rows(cfg, n_past: torch.Tensor, local: bool = False):
    """Lane-expanded (B, Dh) cos and signed-sin rows at each slot's n_past
    (with ``local``, of the SWA layers' frequencies)."""
    inv = inv_freq_for(cfg, n_past.device, local)
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


def moe_route_plain(h2: torch.Tensor, gate_inp: torch.Tensor, cfg):
    """The kernel's router for f32 rows h2 (B, D): (ids int64 (B, k),
    weights f32 (B, k)); k masked-max passes, the first maximum on ties."""
    from .moe import route

    w, ids = route(h2 @ gate_inp.float(), cfg)
    return ids, w


def _qlinear_experts_plain(xb: torch.Tensor, qt: QuantTensor,
                           e: torch.Tensor) -> torch.Tensor:
    """Row b of xb (B, K) f32 through expert e[b] of a stacked QuantTensor,
    as :func:`qlinear_plain` computes one projection (the ids stay on the
    device: no host sync)."""
    vals = values(qt.q[e], qt)
    w = vals.float() * qt.s[e].float().repeat_interleave(qt.group, -2)
    if qt.fmt == "int8":
        w = _bf16r(w)
    y = torch.einsum("bk,bkn->bn", xb, w)
    if qt.m is not None:
        xs = xb.reshape(xb.shape[0], -1, qt.group).sum(-1)
        y = y - torch.einsum("bg,bgn->bn", xs, qt.m[e].float())
    return y[:, : qt.N]


def moe_ffn_plain(h2: torch.Tensor, p, cfg, ids_out: list | None = None) -> torch.Tensor:
    """K6's MoE FFN with the kernel's rounding points: the router reads the
    f32 h2 (JAX kernel ``decode_stream.py:700``), the experts its bf16
    rounding; per chosen expert y = bf16(bf16(act(g)) * bf16(u)) from the
    f32 gate and up, and its down output weighted in f32.  A shared expert
    (JAX ``:683-697``) comes first: y = bf16(bf16(act(bf16(g))) * bf16(u))
    through its down projection, times sigmoid(h2 · shexp_gate_inp) on the
    f32 h2 where the layer has that vector.  h2 (B, D) f32 -> mlp (B, D)
    f32; the chosen ids (B, k) are appended to ``ids_out``."""
    ids, w = moe_route_plain(h2, p["moe_gate_inp"], cfg)
    if ids_out is not None:
        ids_out.append(ids)
    hb = _bf16r(h2)
    mlp = torch.zeros_like(h2)
    if SHEXP_KEYS[0] in p:
        gu = qlinear_plain(hb, p[SHEXP_KEYS[0]])
        Fs = gu.shape[-1] // 2
        y = _bf16r(_bf16r(_act_plain(_bf16r(gu[:, :Fs]), cfg.act_fn)) * _bf16r(gu[:, Fs:]))
        mlp = qlinear_plain(y, p[SHEXP_KEYS[1]])
        if "shexp_gate_inp" in p:
            mlp = mlp * torch.sigmoid(h2 @ p["shexp_gate_inp"].float().reshape(-1, 1))
    for j in range(ids.shape[1]):
        e = ids[:, j]
        g = _qlinear_experts_plain(hb, p["moe_gate"], e)
        u = _qlinear_experts_plain(hb, p["moe_up"], e)
        y = _bf16r(_bf16r(_act_plain(g, cfg.act_fn)) * _bf16r(u))
        mlp = mlp + _qlinear_experts_plain(y, p["moe_down"], e) * w[:, j:j + 1]
    return mlp


def _act_plain(g: torch.Tensor, act_fn: str) -> torch.Tensor:
    """The kernel's FFN activation of f32 g (JAX ``_act_f32``)."""
    if act_fn == "silu":
        return F.silu(g)
    return F.gelu(g, approximate="tanh" if ACTS[act_fn] == 1 else "none")


def decode_layers_plain(params, cfg, x: torch.Tensor, kv,
                        ids_out: list | None = None) -> torch.Tensor:
    """The plain version shared by K6 and K7: x (B, 1, D) -> (B, 1, D) in
    x's dtype, the new K/V rows written at n_past in place.  For an MoE
    stack, each layer's chosen expert ids (B, k) are appended to
    ``ids_out``.  The gemma modes follow the JAX kernels' rounding points:
    q and k normed per head from the bf16 projection and rounded to bf16
    before rope; the attention and FFN outputs rounded to bf16, normed and
    rounded again before their residual adds; bf16(act(g)) * u."""
    layers = params["layers"]
    keys = proj_keys(layers[0])
    split_v = keys[0] == "wqk_fused"
    B, D = x.shape[0], cfg.n_embd
    Hq, Hkv, Dh, F_ = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_ff
    G, Dq, HD = Hq // Hkv, Hq * Dh, Hkv * Dh
    S = kv.k.shape[2]
    scale = cfg.attn_scale or Dh ** -0.5
    dev = x.device
    n_past = kv.n_past.long()
    tables = [_rope_rows(cfg, kv.n_past), _rope_rows(cfg, kv.n_past, local=True)]
    dual = cfg.rope_local_base > 0
    rows = torch.arange(S, device=dev)[None, :]
    bidx = torch.arange(B, device=dev)
    eps = cfg.rms_eps
    post = cfg.post_attn_norm

    xc = x.reshape(B, D).float()
    for li, p in enumerate(layers):
        C, Ss = tables[int(dual and cfg.swa_layers[li])]
        window = cfg.layer_windows[li]
        lo = (n_past - window + 1).clamp(min=0) if window > 0 else torch.zeros_like(n_past)
        live = (rows >= lo[:, None]) & (rows < n_past[:, None])  # (B, S)
        h = _bf16r(_rms(xc, p["attn_norm"], eps))
        qkv = qlinear_plain(h, p[keys[0]])
        if split_v:
            qkv = torch.cat([qkv, qlinear_plain(h, p["wv"])], -1)
        qkv = _bf16r(qkv)
        q = qkv[:, :Dq].reshape(B, Hq, Dh)
        k = qkv[:, Dq:Dq + HD].reshape(B, Hkv, Dh)
        if cfg.qk_norm:
            q = _bf16r(_rms(q, p["q_norm"], eps))
            k = _bf16r(_rms(k, p["k_norm"], eps))
        q = _rotate(q, C, Ss, cfg.rope_interleaved)
        k = _rotate(k, C, Ss, cfg.rope_interleaved)
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

        attn = _bf16r(qlinear_plain(_bf16r(o.reshape(B, Dq)), p["wo"]))
        if post:
            attn = _bf16r(_rms(attn, p["post_attn_norm"], eps))
        xc = _bf16r(_bf16r(xc) + attn)
        if "moe_gate_inp" in p:
            mlp = _bf16r(moe_ffn_plain(_rms(xc, p["ffn_norm"], eps), p, cfg, ids_out))
        else:
            h2 = _bf16r(_rms(xc, p["ffn_norm"], eps))
            gu = qlinear_plain(h2, p["wgateup_fused"])
            g, u = _bf16r(gu[:, :F_]), _bf16r(gu[:, F_:])
            y = _bf16r(_bf16r(_act_plain(g, cfg.act_fn)) * u)
            mlp = _bf16r(qlinear_plain(y, p["w_down"]))
        if post:
            mlp = _bf16r(_rms(mlp, p["post_ffn_norm"], eps))
        xc = _bf16r(_bf16r(xc) + mlp)
    return xc.to(x.dtype).reshape(B, 1, D)


# ---------------------------------------------------------------------------
# the launch (K6 and K7)
# ---------------------------------------------------------------------------

MAX_G = 16          # query heads per KV head the kernel takes
MAX_QDIM = 4096     # G * Dh
MAX_SPLIT = 32      # key-range splits per (slot, KV head)
TABLE_W = 50        # int64 words per layer in the plane table
NPROJ = 8           # q|k|v, v, o, gate|up, down, expert gate, up, down


class ProjDims(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in
                ("K", "N", "group", "sgroup", "ck", "seg", "nib")]


class DecodeArgs(ctypes.Structure):
    """Mirrors ``DecodeArgs`` in ``csrc/decode_stream.cu``."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "table", "kc", "vc", "n_past", "inv_freq", "inv_freq_local", "x0",
        "xin", "xmid", "xout", "qkv_acc", "o_acc", "gu_acc", "dn_acc", "obuf", "part",
        "selfs", "bar", "eids", "gpart", "gcnt")]
        + [("proj", ProjDims * NPROJ)]
        + [(n, ctypes.c_int) for n in (
            "L", "B", "D", "Hq", "Hkv", "Dh", "F", "S", "nsplit", "split_v",
            "interleaved", "n_exp", "topk", "gating_sigmoid",
            "wnorm", "has_qk", "has_post", "act", "Fs", "has_shexp")]
        + [(n, ctypes.c_float) for n in ("scale", "eps", "wscale")])


def _splits(d: ProjDims) -> int:
    return (d.K // 2 if d.nib else d.K) // d.seg


def _tiles(d: ProjDims) -> int:
    return -(-d.N // 128)


def gemv_scratch(proj, mp: int, moe: bool, topk: int, split_v: bool,
                 shexp: bool) -> tuple[int, int]:
    """(f32 words, counters) the kernel's ordered GEMV sums need in the
    largest phase: every segment's partial sums of each projection a phase
    runs (``csrc/decode_stream.cu``: P1 q|k|v and v, P5 o, P6 gate|up or
    the chosen experts' gate and up and the shared expert's gate|up, P7
    down or the shared expert's and the experts' downs into one sum), and
    one counter per 128-column tile of each."""
    def part(d, rows=mp):
        return _splits(d) * rows * d.N

    qkv, v, o, gu, dn, eg, eu, ed = proj
    phases = [(part(qkv) + (part(v) if split_v else 0),
               _tiles(qkv) + (_tiles(v) if split_v else 0)),
              (part(o), _tiles(o))]
    if moe:
        phases += [(2 * topk * part(eg, 1) + (part(gu, 1) if shexp else 0),
                    2 * topk * _tiles(eg) + (_tiles(gu) if shexp else 0)),
                   ((_splits(dn) if shexp else 0) * ed.N + topk * part(ed, 1), _tiles(ed))]
    else:
        phases += [(part(gu), _tiles(gu)), (part(dn), _tiles(dn))]
    return max(p for p, _ in phases), max(c for _, c in phases)


class _Workspace:
    """Scratch of one (params, B, S, cache dtype, kernel): allocated once
    and reused by every step, so a step allocates nothing of its own.  An
    MoE stack's gate|up accumulator holds the k chosen experts' gate and
    up rows, then the shared expert's gate|up row, and ``eids`` (L, k) the
    ids the last step chose.  ``gpart`` and ``gcnt`` hold the GEMVs'
    partial sums by segment and their column tiles' arrival counters
    (:func:`gemv_scratch`; zero at rest: the kernel resets each counter
    it used)."""

    def __init__(self, cfg, mp: int, B: int, Nqkv: int, dev, scratch: tuple[int, int],
                 expert_n: int = 0, shexp_n: int = 0):
        D, F_, Dh = cfg.n_embd, cfg.n_ff, cfg.head_dim
        G = cfg.n_heads // cfg.n_kv_heads
        f32 = dict(dtype=torch.float32, device=dev)
        self.gu_len = max(mp * 2 * F_, cfg.n_experts_used * 2 * expert_n + shexp_n)
        self.acc = torch.zeros(mp * (Nqkv + 2 * D) + self.gu_len, **f32)
        self.qkv_acc, self.o_acc, self.gu_acc, self.dn_acc = torch.split(
            self.acc, [mp * Nqkv, mp * D, self.gu_len, mp * D])
        self.gpart = torch.zeros(max(1, scratch[0]), **f32)
        self.gcnt = torch.zeros(max(1, scratch[1]), dtype=torch.int32, device=dev)
        self.eids = torch.zeros((cfg.n_layers, max(1, cfg.n_experts_used)),
                                dtype=torch.int32, device=dev)
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
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        so.lcg_decode_step.restype = ctypes.c_int
        so.lcg_decode_step.argtypes = [
            ctypes.POINTER(DecodeArgs), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    return so


def _call(so, k7: bool, args, mp: int, folded: bool, kv_bf16: bool,
          moe: bool, gemma: bool, query_only: bool, dev) -> int:
    grid = ctypes.c_int(0)
    if k7:
        err = so.lcg_decode_step(ctypes.byref(args), int(kv_bf16), int(gemma),
                                 int(query_only), ctypes.byref(grid),
                                 kernels.stream(dev))
    else:
        err = so.lcg_decode_stream(ctypes.byref(args), mp, int(folded),
                                   int(kv_bf16), int(moe), int(gemma),
                                   int(query_only), ctypes.byref(grid),
                                   kernels.stream(dev))
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
    moe = keys[-1] == EXPERT_KEYS[-1]
    shexp = SHEXP_KEYS[0] in keys
    if moe and (k7 or B != 1):
        raise ValueError("decode kernel: an MoE stack runs on K6 at B = 1")
    qts = [layers[0][k] for k in keys]
    folded = qts[0].sd is not None
    Nqkv = Hq * Dh + 2 * Hkv * Dh
    args = DecodeArgs()
    slots = (((0, 1, 2) if split_v else (0, 2)) + ((3, 4) if shexp else ())
             + ((5, 6, 7) if moe else (3, 4)))
    for slot, qt in zip(slots, qts):
        seg, ck = _gemv_segment(qt)
        args.proj[slot] = ProjDims(qt.K, qt.N, qt.group, qt.sgroup or 1, ck,
                                   seg, int(qt.fmt == "nib4c"))
    if moe and _splits(args.proj[5]) != _splits(args.proj[6]):
        raise ValueError("decode kernel: expert gate and up of different K splits")
    wkey = (B, kv.k.shape[2], kv.k.dtype, k7)
    spaces = params.__dict__.setdefault("_decode_workspaces", {})
    ws = spaces.get(wkey)
    if ws is None:
        scratch = gemv_scratch(args.proj, mp, moe, cfg.n_experts_used, split_v, shexp)
        ws = spaces[wkey] = _Workspace(cfg, mp, B, Nqkv, dev, scratch,
                                       qts[-3].N if moe else 0,
                                       layers[0][SHEXP_KEYS[0]].N if shexp else 0)

    for name, t in (("table", layer_table(params, cfg)), ("kc", kv.k),
                    ("vc", kv.v), ("n_past", kv.n_past),
                    ("inv_freq", inv_freq_for(cfg, dev)),
                    ("inv_freq_local", inv_freq_for(cfg, dev, local=True)),
                    ("x0", ws.x0),
                    ("xin", ws.xin), ("xmid", ws.xmid), ("xout", ws.xout),
                    ("qkv_acc", ws.qkv_acc), ("o_acc", ws.o_acc),
                    ("gu_acc", ws.gu_acc), ("dn_acc", ws.dn_acc),
                    ("obuf", ws.obuf), ("part", ws.part), ("selfs", ws.selfs),
                    ("bar", ws.bar), ("eids", ws.eids), ("gpart", ws.gpart),
                    ("gcnt", ws.gcnt)):
        setattr(args, name, t.data_ptr())
    args.L, args.B, args.D = cfg.n_layers, B, D
    args.Hq, args.Hkv, args.Dh, args.F = Hq, Hkv, Dh, cfg.n_ff
    args.S = kv.k.shape[2]
    args.split_v, args.interleaved = int(split_v), int(cfg.rope_interleaved)
    args.scale = float(cfg.attn_scale or Dh ** -0.5)
    args.eps = float(cfg.rms_eps)
    if moe:
        args.n_exp, args.topk = cfg.n_experts, cfg.n_experts_used
        args.gating_sigmoid = int(cfg.expert_gating_func == 2)
        args.wnorm = int(cfg.expert_weights_norm)
        args.wscale = float(cfg.expert_weights_scale)
        if shexp:
            args.has_shexp, args.Fs = 1, args.proj[3].N // 2
    gemma = gemma_mode(cfg)
    args.has_qk, args.has_post = int(cfg.qk_norm), int(cfg.post_attn_norm)
    args.act = ACTS[cfg.act_fn]

    so = _so()
    kv_bf16 = kv.k.dtype == torch.bfloat16
    gkey = (k7, mp, folded, kv_bf16, moe, gemma)
    grids = params.__dict__.setdefault("_decode_grids", {})
    if gkey not in grids:
        grids[gkey] = _call(so, k7, args, mp, folded, kv_bf16, moe, gemma, True, dev)
    args.nsplit = max(1, min(MAX_SPLIT, grids[gkey] // (B * Hkv)))
    if kv.n_past.dtype != torch.int32 or kv.n_past.device != dev:
        raise ValueError("decode kernel: n_past must be int32 on the card")
    ws.x0[:B].copy_(x.reshape(B, D))
    _call(so, k7, args, mp, folded, kv_bf16, moe, gemma, False, dev)
    return ws.xout[:B].to(x.dtype, copy=True).reshape(B, 1, D)


def last_expert_ids(params, kv) -> torch.Tensor:
    """The expert ids (L, k) that K6's last MoE step on a cache shaped like
    ``kv`` chose, from its device buffer."""
    ws = params.__dict__["_decode_workspaces"][(1, kv.k.shape[2], kv.k.dtype, False)]
    return ws.eids.clone()


# K6's shared-expert mode, counted apart (device slot 7) beside the MoE
# launch it is part of
SHEXP_COUNT = kernels.mode_count("decode_stream_shexp", "decode_stream", 7)


@kernels.counted("decode_stream", lib="decode_stream", slot=1, modes=("moe", "gemma"))
def fused_decode_step_streamed(params, cfg, x: torch.Tensor, kv) -> torch.Tensor:
    """K6: x (B, 1, D) through every layer, the KV updated in place (see the
    module docstring); an MoE stack's launch also counts as
    ``decode_stream_moe``, a gemma one (qk-norm included) as
    ``decode_stream_gemma``, both as ``decode_stream_moe_gemma``, and one
    with a shared expert as ``decode_stream_shexp`` too.  On the CPU, the
    plain version."""
    if x.device.type == "cpu":
        return fused_decode_step_streamed_plain(params, cfg, x, kv)
    out = launch_decode(params, cfg, x, kv, k7=False)
    p = params["layers"][0]
    kernels.count(fused_decode_step_streamed, "moe_gate_inp" in p, gemma_mode(cfg))
    if SHEXP_KEYS[0] in p:
        kernels.count(SHEXP_COUNT)
    return out


def fused_decode_step_streamed_plain(params, cfg, x, kv) -> torch.Tensor:
    """Plain version of K6 (the same contract)."""
    return decode_layers_plain(params, cfg, x, kv)
