"""K3: decode attention for a few new queries per KV head.

Port of ``llama_cpp_gfx906_tpu/ops/flash_decode.py::flash_decode`` for a
bf16, f32 or q8 (``QuantKV``: int8 rows and per-row scales) cache, with GQA,
the ``n_past`` offset, sliding window, softcap, sinks, a batch-shared
prefix segment ``shared_k``/``shared_v`` (1, S0, Hkv, D) in the compute
dtype, walked before each sequence's own rows, ALiBi slopes (Hq,) and
self-extend logical positions ``kv_pos`` (B, S) / ``q_pos`` (B, T) (not
with a shared segment, as in JAX).  The kernel
(``csrc/flash_decode.cu``) is split-KV flash-decoding: each (batch, KV
head, tile of up to 8 queries) has its live key tiles dealt out to
``splits`` blocks, which the last block to finish merges in split order;
it reads q and the rows in their stored layouts, dequantizing int8 rows in
the kernel, and writes the output in place; see the source for its design
and bound.
:func:`flash_decode_split_plain` computes the same split and merge in plain
PyTorch (for the tests).
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .kv_quant import QuantKV, dequantize_rows

MAX_QUERIES = 128  # G*T queries per KV head the kernel takes
KEY_TILE = 16      # keys per tile (csrc/flash_decode.cu SUB)
MAX_SPLITS = 32    # splits of a head's keys at most (MAX_SPLIT)
# key tiles a split takes at least, passed to the kernel: the MPT-7B 8-step
# fused-vs-loop check passes at 16 and fails at 4, 8 and 32 (PERF.md §6)
SPLIT_MIN_TILES = 16
H100_SMS = 132
_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def query_tile(NQ: int) -> int:
    """The queries a block of the kernel takes, of the NQ of a KV head: one
    (MHA decode: MPT, BLOOM), 4 (the 8B's G 4, Gemma's G 2) or 8 (a kernel
    instantiation each)."""
    return 1 if NQ <= 1 else 4 if NQ <= 4 else 8


def splits(B: int, Hkv: int, NQ: int, S: int, S0: int = 0, sms: int = H100_SMS) -> int:
    """The kernel's split count, from the shapes alone (never ``n_past``, so
    that a captured step replays one grid as ``n_past`` moves): up to two
    blocks an SM over the B * Hkv * ceil(NQ / query_tile) (slot, head,
    query tile) triples, at most ``MAX_SPLITS`` and at most the key tiles
    of a full cache.  That is one wave where two blocks fit an SM; at Dh
    256 with bf16 rows a block's rings take 128 KB, one fits, and the grid
    runs in two waves.  A launch takes fewer where n_past
    leaves fewer than ``SPLIT_MIN_TILES`` tiles a split (:func:`split_rows`)."""
    base = B * Hkv * -(-NQ // query_tile(NQ))
    tiles = -(-S // KEY_TILE) + -(-S0 // KEY_TILE)
    return max(1, min(2 * sms // base, MAX_SPLITS, tiles))


def split_rows(n_past: int, T: int, S: int, S0: int, window: int, positions: bool,
               nsplit: int, min_tiles: int = SPLIT_MIN_TILES) -> list[torch.Tensor]:
    """The keys each split of one slot takes, as the kernel deals them out:
    indices into the shared rows then the own ones (0 .. S0 + S - 1).  The
    live rows are the shared rows inside the window and the own rows
    [lo, n_past + T) (lo past the window, unless logical positions are
    set), each segment cut into tiles of ``KEY_TILE`` rows; of the n tiles,
    split s < e = max(1, min(nsplit, n // min_tiles)) takes tiles
    [s * n / e, (s + 1) * n / e), the others none.  The wrapper passes the
    kernel ``SPLIT_MIN_TILES``; a smaller ``min_tiles`` reaches many
    splits over a cache short enough for the CPU tests."""
    hi = min(n_past + T, S)
    lo = max(0, n_past + 1 - window) if window > 0 and not positions else 0
    slo = min(S0, max(0, S0 + n_past + 1 - window)) if window > 0 else 0
    tiles = [(r, min(r + KEY_TILE, S0)) for r in range(slo, S0, KEY_TILE)]
    tiles += [(S0 + r, S0 + min(r + KEY_TILE, hi)) for r in range(lo, hi, KEY_TILE)]
    n = len(tiles)
    e = max(1, min(nsplit, n // min_tiles))
    return [torch.cat([torch.arange(a, b) for a, b in tiles[s * n // e:(s + 1) * n // e]]
                      or [torch.zeros(0, dtype=torch.long)]) if s < e
            else torch.zeros(0, dtype=torch.long) for s in range(nsplit)]


def flash_decode_plain(q, k_cache, v_cache, n_past, scale: float,
                       sliding_window: int = 0, logit_softcap: float = 0.0,
                       sinks=None, shared_k=None, shared_v=None, alibi_slopes=None,
                       kv_pos=None, q_pos=None) -> torch.Tensor:
    """Plain version of K3: the masked-softmax einsum, over rows
    dequantized to f32 for a q8 cache."""
    from .attention import attend

    if isinstance(k_cache, QuantKV):
        k_cache = dequantize_rows(k_cache, torch.float32)
        v_cache = dequantize_rows(v_cache, torch.float32)
    return attend(q, k_cache, v_cache, n_past, scale, sliding_window,
                  logit_softcap, sinks, kv_pos=kv_pos, q_pos=q_pos,
                  alibi_slopes=alibi_slopes, shared_k=shared_k, shared_v=shared_v)


def flash_decode_split_plain(q, k_cache, v_cache, n_past, scale: float,
                             sliding_window: int = 0, logit_softcap: float = 0.0,
                             sinks=None, shared_k=None, shared_v=None, alibi_slopes=None,
                             kv_pos=None, q_pos=None, nsplit: int | None = None,
                             min_tiles: int = SPLIT_MIN_TILES) -> torch.Tensor:
    """K3's split and merge in plain PyTorch, in f32: each split's softmax
    state (m, l, acc) over the keys :func:`split_rows` gives it (m = -1e30,
    l = 0, acc = 0 for a split without them), merged in split order, each
    rescaled by exp(m_s - M), the sink joining the denominator once, after
    the merge.  ``nsplit`` defaults to :func:`splits` on an H100."""
    from .attention import NEG_INF, attention_logits

    if isinstance(k_cache, QuantKV):
        k_cache = dequantize_rows(k_cache, torch.float32)
        v_cache = dequantize_rows(v_cache, torch.float32)
    B, T, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    S0 = shared_k.shape[1] if shared_k is not None else 0
    if nsplit is None:
        nsplit = splits(B, Hkv, G * T, S, S0)
    scores, mask = attention_logits(q, k_cache, n_past, scale, sliding_window,
                                    logit_softcap, kv_pos, q_pos, alibi_slopes, shared_k)
    v = v_cache.float()
    if S0:
        v = torch.cat([shared_v.float().expand(B, -1, -1, -1), v], 1)
    mask = mask.expand(B, -1, -1)
    out = torch.empty((B, Hkv, G, T, D), dtype=torch.float32, device=q.device)
    for b in range(B):
        ms, ls, accs = [], [], []
        for rows in split_rows(int(n_past[b]), T, S, S0, sliding_window, kv_pos is not None,
                               nsplit, min_tiles):
            rows = rows.to(q.device)
            sc, seen = scores[b][..., rows], mask[b][:, rows]  # (Hkv, G, T, n), (T, n)
            sc = torch.where(seen, sc, -torch.inf)
            m = torch.clamp(sc.amax(-1) if rows.numel() else torch.full(sc.shape[:-1], -torch.inf),
                            min=NEG_INF)
            p = torch.where(seen, torch.exp(sc - m[..., None]), 0.0)
            ms.append(m)
            ls.append(p.sum(-1))
            accs.append(torch.einsum("hgtn,nhd->hgtd", p, v[b][rows]))
        M = torch.stack(ms).amax(0)
        L = torch.zeros_like(M)
        acc = torch.zeros((Hkv, G, T, D), dtype=torch.float32, device=q.device)
        for m, l, a in zip(ms, ls, accs):
            w = torch.where(l > 0, torch.exp(m - M), 0.0)
            L = L + w * l
            acc = acc + w[..., None] * a
        alpha = torch.ones_like(M)
        if sinks is not None:
            sk = sinks.to(q.device).float().reshape(Hkv, G, 1)
            m_new = torch.maximum(M, sk)
            alpha = torch.exp(M - m_new)
            L = L * alpha + torch.exp(sk - m_new)
        out[b] = acc * (alpha / torch.clamp(L, min=1e-30))[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, D).to(q.dtype)


_SMS: dict = {}
_WORKSPACE: dict = {}


def _sms(device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def split_count(q, k_cache, shared_k=None) -> int:
    """:func:`splits` for ``flash_decode(q, k_cache, ..., shared_k=...)`` on
    q's card."""
    kq = k_cache.q if isinstance(k_cache, QuantKV) else k_cache
    B, T, Hq, _ = q.shape
    S, Hkv = kq.shape[1], kq.shape[2]
    S0 = shared_k.shape[1] if shared_k is not None else 0
    return splits(B, Hkv, Hq // Hkv * T, S, S0, _sms(q.device))


def _workspace(device, sms: int) -> torch.Tensor:
    """The partials' buffer on ``device``: enough for every launch, since
    :func:`splits` keeps the blocks of a split launch within 2 an SM, each
    holding at most 8 queries' (m, l, acc[D <= 256]).  Made at the first split launch, which a graph
    capture must not be (the engines warm a step up eagerly first)."""
    buf = _WORKSPACE.get(device)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("flash_decode: launch once before a graph capture")
        buf = _WORKSPACE[device] = torch.empty(2 * sms * 8 * (256 + 2),
                                               dtype=torch.float32, device=device)
    return buf


@kernels.counted("flash_decode", lib="flash_decode",
                 modes=("int8", "shared", "alibi", "pos"))
def flash_decode(q, k_cache, v_cache, n_past, scale: float,
                 sliding_window: int = 0, logit_softcap: float = 0.0,
                 sinks=None, shared_k=None, shared_v=None, alibi_slopes=None,
                 kv_pos=None, q_pos=None) -> torch.Tensor:
    """Attention of q (B, T, Hq, D) over the cache (B, S, Hkv, D) or a
    ``QuantKV`` of that shape, which already holds the T new rows at n_past,
    after the shared rows (1, S0, Hkv, D) when given; returns (B, T, Hq, D)
    in q's dtype.  ``alibi_slopes`` (Hq,) bias the scores by distance;
    ``kv_pos`` (B, S) and ``q_pos`` (B, T) are the rows' and the queries'
    logical positions (self-extend)."""
    if (kv_pos is None) != (q_pos is None):
        raise ValueError("flash_decode: kv_pos and q_pos go together")
    if kv_pos is not None and shared_k is not None:
        raise NotImplementedError("shared-prefix KV + self-extend positions")
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, n_past, scale,
                                  sliding_window, logit_softcap, sinks,
                                  shared_k, shared_v, alibi_slopes, kv_pos, q_pos)
    quant = isinstance(k_cache, QuantKV)
    if quant != isinstance(v_cache, QuantKV):
        raise ValueError("flash_decode: K and V caches of different kinds")
    kq, vq = (k_cache.q, v_cache.q) if quant else (k_cache, v_cache)
    B, T, Hq, D = q.shape
    S, Hkv = kq.shape[1], kq.shape[2]
    G = Hq // Hkv
    NQ = G * T
    if kq.dtype not in _KIND or vq.dtype != kq.dtype:
        raise ValueError(f"flash_decode: unsupported cache dtype {kq.dtype}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("flash_decode: the cache must be contiguous")
    # q and the output in the compute type: the cache's, or the shared
    # rows' beside an int8 cache (without them, q's bf16 or f32)
    q_kind = _KIND[kq.dtype] if not quant else 1 if q.dtype == torch.bfloat16 else 0
    S0, sh_kind, shk, shv = 0, q_kind, None, None
    if shared_k is not None:
        S0 = shared_k.shape[1]
        shk, shv = shared_k.contiguous(), shared_v.contiguous()
        if shk.shape != (1, S0, Hkv, D) or shv.shape != shk.shape:
            raise ValueError(f"flash_decode: shared rows {tuple(shk.shape)}, "
                             f"want (1, S0, {Hkv}, {D})")
        sh_kind = _KIND.get(shk.dtype, -1)
        if shv.dtype != shk.dtype or sh_kind not in (0, 1) or (
                not quant and shk.dtype != kq.dtype):
            raise ValueError(f"flash_decode: shared rows of dtype {shk.dtype} "
                             f"beside a {kq.dtype} cache")
        q_kind = sh_kind
    f32_tile = torch.float32 in (kq.dtype, shk.dtype if S0 else kq.dtype)
    if NQ > MAX_QUERIES or D not in (64, 128, 256) or (D == 256 and f32_tile):
        raise ValueError(f"flash_decode: G*T = {NQ} (at most {MAX_QUERIES}), "
                         f"head dim {D} (64, 128, or 256 without f32 rows)")
    # the kernel reads q (B, T, Hq, D) and writes the output in place, in
    # the compute type (a q of another type is rounded to it, as the JAX
    # kernel rounds q to bf16)
    qk = q.to([torch.float32, torch.bfloat16][q_kind]).contiguous()
    sinks_h, slopes_h = (None if x is None else x.to(q.device, torch.float32).contiguous()
                         for x in (sinks, alibi_slopes))
    if any(x is not None and x.shape != (Hq,) for x in (sinks_h, slopes_h)):
        raise ValueError(f"flash_decode: sinks and ALiBi slopes take one value per query "
                         f"head ({Hq},)")
    kvp = qp = None
    if kv_pos is not None:
        kvp = kv_pos.to(device=q.device, dtype=torch.int32).contiguous()
        qp = q_pos.to(device=q.device, dtype=torch.int32).contiguous()
        if kvp.shape != (B, S) or qp.shape != (B, T):
            raise ValueError(f"flash_decode: positions {tuple(kvp.shape)} / "
                             f"{tuple(qp.shape)}, want ({B}, {S}) / ({B}, {T})")
    out = torch.empty_like(qk)
    npast = n_past.to(device=q.device, dtype=torch.int32).contiguous()
    ks = vs = None
    if quant:
        ks, vs = k_cache.s, v_cache.s  # (B, S, Hkv, 1) f32: row-major (B, S, Hkv)
    nsplit = split_count(q, k_cache, shared_k)
    part = cnt = None
    if nsplit > 1:
        n_tiles = B * Hkv * -(-NQ // query_tile(NQ))
        part = _workspace(q.device, _sms(q.device))
        if n_tiles * nsplit * query_tile(NQ) * (D + 2) > part.numel():
            raise ValueError(f"flash_decode: {n_tiles} x {nsplit} partials exceed the workspace")
        cnt = kernels.tile_counters(q.device, n_tiles)
    so = kernels.lib("flash_decode")
    if so.lcg_flash_decode.argtypes is None:
        so.lcg_flash_decode.restype = ctypes.c_int
        so.lcg_flash_decode.argtypes = (
            [ctypes.c_int] * 4 + [ctypes.c_void_p] * 7 + [ctypes.c_int]
            + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 3)
    err = so.lcg_flash_decode(
        _KIND[kq.dtype], sh_kind, q_kind, D,
        *map(kernels.ptr, (qk, kq, vq, ks, vs, shk, shv)), S0,
        *map(kernels.ptr, (npast, sinks_h, slopes_h, kvp, qp, out)),
        B, S, Hkv, NQ, T, float(scale), int(sliding_window),
        float(logit_softcap), query_tile(NQ), nsplit, SPLIT_MIN_TILES, kernels.ptr(part),
        kernels.ptr(cnt),
        kernels.stream(q.device))
    kernels.check(so, err, "flash_decode")
    kernels.count(flash_decode, quant, S0 > 0, alibi_slopes is not None,
                  kv_pos is not None)
    return out.to(q.dtype)
