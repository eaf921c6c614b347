"""Device times of the split-K kernels, K3, K4 and the nib4 modes, at the main paths' shapes.

The cases live here, and ``chip_smoke.py`` builds its kernel cases from the
same lists: K1 / K2 (``GEMV_CASES``: the 8B head, ``attn_v`` and Q4_K
projections), K8 (``EXPERT_CASES``: Mixtral's experts at 2 and 8 pairs)
and K6 / K7 in each mode (``DECODE_CASES``: a few full-width layers of
each model, or a small model's whole stack) and K3 in each mode
(``K3_CASES``: the 8B's, MPT-7B's and BLOOM-7B1's heads and the JAX tests'
shape; :func:`k3_case` makes their inputs) and K4 in each mode
(``K4_CASES``: every prefill shape of the model phases; :func:`k4_case`
makes their inputs); at gpt-oss-20b's shapes, K5's
and K8's nib4 modes (``QMM_NIB4_CASES``, ``RQMM_NIB4_CASES`` on
:func:`oss_experts`), K1 / K2 (``OSS_GEMV_CASES``), K5's int8 mode
(``OSS_QMM_INT8_CASES``) and K3 with sinks (``OSS_ATTN_CASES``).
Each is timed as ``chip_smoke.py`` times a kernel (:func:`device_ms`).
The ``prefill`` group times the model phases' whole prefills instead
(``PREFILL_CASES``, :func:`prefill_times`), by the host's clock.
Synthetic weights from seed 0; caches of random rows filled to n_past
3000.  With ``--splits``, K1 / K2 are also timed at every split count the
kernel takes (``gemv_splits`` picks one of them).  ``--kernels`` picks
the groups to build and time (default all); the wall time of each build
is printed.

``--root`` imports the package from another checkout (run the script by
its path, so that no package is imported before it), so two versions of the
kernels can be timed on one card in one session, in turns; a case whose
preset or mode that checkout lacks is left out:

    python llama_cpp_gfx906_tpu_torch/tools/kernel_times.py --root OLD --label old
    python llama_cpp_gfx906_tpu_torch/tools/kernel_times.py --label new

Prints one JSON line per case, and the card (``nvidia-smi`` name and power
limit) first.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# (kernel, case, GGML type, K, N, N padded to whole 128-column tiles)
GEMV_CASES = (
    ("gemv_int8", "lm_head 4096x129024", "Q6_K", 4096, 128256, True),
    ("gemv_int8", "attn_v 4096x1024", "Q6_K", 4096, 1024, False),
    ("gemv_nib4c", "attn_qk 4096x5120", "Q4_K", 4096, 5120, False),
    ("gemv_nib4c", "attn_output 4096x4096", "Q4_K", 4096, 4096, False),
    ("gemv_nib4c", "ffn_gate_up 4096x28672", "Q4_K", 4096, 28672, False),
    ("gemv_nib4c", "ffn_down 14336x4096", "Q4_K", 14336, 4096, False))
EXPERTS = 8  # Mixtral's
# (case, GGML type, N, K, pair counts): Q8_0 experts, and Q4_K ones unified
# to int8 with mins (group 16)
EXPERT_CASES = (
    ("gate 4096x14336", "Q8_0", 14336, 4096, (2, 8)),
    ("down 14336x4096", "Q8_0", 4096, 14336, (2, 8)),
    ("gate 4096x14336 with mins", "Q4_K", 14336, 4096, (2,)))
# (kernel count name, synth preset, layers (None: all), batch sizes, synth
# options): K6 on full-width layers of each model, K7 on the small models
DECODE_CASES = (
    ("decode_stream", "8b", 2, (1, 8), {}),
    ("decode_step", "270m-q8_0", None, (1,), {}),
    ("decode_stream_gemma", "gemma3-4b-q4_k_m", 6, (1, 4), {}),
    ("decode_step_gemma", "gemma3-270m-q8_0", None, (1,), {}),
    ("decode_stream_moe", "mixtral-q4_k_m", 2, (1,), {}),
    ("decode_stream_moe", "mixtral-q8_0", 2, (1,), {}),
    ("decode_stream_qk_norm", "qwen3-8b-q4_k_m", 2, (1, 4), {}),
    ("decode_stream_moe_qk_norm", "qwen3moe-30b-a3b-q4_k_m", 2, (1,), {}),
    ("decode_stream_shexp", "qwen2moe-a2.7b-q8_0", 2, (1,), dict(attn_bias=False)))
# (mode, case, (query heads, KV heads), n_past per slot, T, options): K3
# at Dh 128 over 4096 rows of random bf16 K/V.  The mode is the wrapper's
# (``flash_decode.modes``: its flags int8, shared, alibi, pos joined by
# "_"; "" for none).  Options: ``D`` and ``S`` (head dim, rows), ``S0``
# (shared rows), ``pos`` (``("div", g)``: row i at i // g, the new tokens
# continuing; ``("gan", n, w)``: the CLI's ``-gan n -gaw w`` ladder,
# :func:`ladder_positions`), ``softcap``, ``window``.  The old modes at
# the 8B's heads; ALiBi at MPT-7B's and BLOOM-7B1's 32/32 heads: decode at
# n_past 700 and 3000, B 1 and 4, after 512 shared rows, and their prefill
# chunks of G·T <= 128 (101 tokens at n_past 0, 128 at 700); self-extend at
# the 8B's, the new rows ending at row 3000; both at the JAX kernel tests'
# shape (B 2, 4/2 heads of 64, 384 rows).  A mode the checkout's K3 lacks is
# left out.
_JAX_SHAPE = dict(D=64, S=384)
K3_CASES = (
    ("", "8b B=1 bf16 n_past=3000", (32, 8), (3000,), 1, {}),
    ("int8", "8b B=4 int8 n_past=700/3000", (32, 8), (700, 3000) * 2, 1, {}),
    ("shared", "8b B=4 bf16 S0=512 n_past=700", (32, 8), (700,) * 4, 1, dict(S0=512)),
    *((f"{i8}{mode}", f"mpt{what} {kind} n_past={'/'.join(map(str, n_past))}", (32, 32),
       n_past, T, opts)
      for i8, kind in (("", "bf16"), ("int8_", "int8"))
      for mode, what, n_past, T, opts in (
          ("alibi", " B=1", (700,), 1, {}), ("alibi", " B=1", (3000,), 1, {}),
          ("alibi", " B=4", (700, 3000) * 2, 1, {}),
          ("shared_alibi", " B=4 S0=512", (700,) * 4, 1, dict(S0=512)),
          ("alibi", "/bloom prefill T=101", (0,), 101, {}),
          ("alibi", "/bloom prefill T=128", (700,), 128, {}))),
    ("alibi", "jax shape softcap=25 window=96", (4, 2), (300, 120), 1,
     dict(_JAX_SHAPE, softcap=25.0, window=96)),
    *((f"{i8}pos", f"8b {ladder} T={T} {kind}", (32, 8), (3001 - T,), T, dict(pos=pos))
      for i8, kind in (("", "bf16"), ("int8_", "int8"))
      for ladder, pos in (("i//4", ("div", 4)), ("gan4 gaw1024", ("gan", 4, 1024)))
      for T in (1, 4)),
    ("alibi_pos", "jax shape alibi i//2", (4, 2), (300, 120), 1,
     dict(_JAX_SHAPE, pos=("div", 2))),
    ("pos", "jax shape window=32 i//3 T=4", (4, 2), (300, 120), 4,
     dict(_JAX_SHAPE, pos=("div", 3), window=32)))
# gpt-oss-20b: Q4_0 experts (32), K = D = 2880, the expert FF 2880 padded
# to 3072 (gate and up: split-K nib4, no nib4c chunk at 2880)
OSS_D, OSS_EF, OSS_E = 2880, 2880, 32
# (case, M): K5-nib4 on one gate expert at the prefill chunks of the
# gpt_oss_20b phase (101 and 256 rows: ragged chunks; 1000: its prompt)
QMM_NIB4_CASES = tuple((f"gate 2880x3072 M={M}", M) for M in (101, 256, 1000))
# (case, P): K8-nib4 on the gate experts for one token's 4 pairs and two
# tokens' 8, distinct experts per token, with mins (Q4_0: m = 8 d)
RQMM_NIB4_CASES = tuple((f"gate 2880x3072 with mins P={P}", P) for P in (4, 8))
# K1 at K 2880 (q|k|v with mins, the head's 2880 rows) and K2 at N 2880
OSS_GEMV_CASES = (
    ("gemv_int8", "attn_qkv 2880x5120 with mins", "Q4_0", 2880, 5120, False),
    ("gemv_int8", "lm_head 2880x201088", "Q8_0", 2880, 201088, True),
    ("gemv_nib4c", "attn_output 4096x2880", "Q4_0", 4096, 2880, False))
# K5's int8 mode at K 2880: the fused q|k|v with mins at the prefill chunks
OSS_QMM_INT8_CASES = tuple((f"attn_qkv 2880x5120 with mins M={M}", M) for M in (101, 1000))
# (kernel, case, T, n_past, window): K3 at 64/8 heads of 64 with sinks,
# window 128 (the even layers) and full, one slot of 4096 rows (K4's
# gpt-oss cases are in ``K4_CASES``)
OSS_ATTN_CASES = tuple(
    ("flash_decode", f"gpt-oss 64/8 Dh64 sinks T=1 n_past={n} window={w}", 1, n, w)
    for n in (700, 3000) for w in (128, 0))
# (mode, case, (query heads, KV heads), head dim, T, n_past, options): K4
# over 4096 rows of random K/V of one slot.  The mode is the wrapper's
# (``flash_attention.modes``: "mma" for the tensor-core body, "int8" for an
# int8 cache, "" for the FMA body of an f32 q).  Options: ``window``,
# ``sinks``.  The 8B's prefill (T 512 at n_past 0 and 256); the served q8
# chunks at the 8B's and tinydoc's heads (T 256 at n_past 0 / 256 / 700);
# the Qwen group sizes G 7 and G 8 (ragged chunks: 101 and 256 tokens at 0,
# a 44-token tail at 256), bf16 and int8; gpt-oss-20b's 64/8 heads of 64
# with sinks, window 128 and full; Gemma-3-4B's 8/4 heads of 256 (T 512,
# window 1024 and full, and its 1,500-token prefill in the window); the FMA
# body at tinydoc's heads (an f32 and an int8 cache).
K4_CASES = (
    *(("mma", f"8B 32/8 T=512 n_past={n}", (32, 8), 128, 512, n, {}) for n in (0, 256)),
    *(("int8_mma", f"{shape} T=256 n_past={n}", heads, D, 256, n, {})
      for shape, heads, D in (("8b", (32, 8), 128), ("tinydoc", (4, 2), 64))
      for n in (0, 256, 700)),
    *((f"{i8}mma", f"{shape} {kind} T={T} n_past={n}", heads, 128, T, n, {})
      for shape, heads in (("G7 28/4", (28, 4)), ("G8 32/4", (32, 4)))
      for i8, kind in (("", "bf16"), ("int8_", "int8"))
      for T, n in ((101, 0), (256, 0), (44, 256))),
    *(("mma", f"gpt-oss 64/8 Dh64 sinks T={T} n_past={n} window={w}", (64, 8), 64, T, n,
       dict(window=w, sinks=True))
      for T, n in ((101, 0), (256, 0), (44, 256)) for w in (128, 0)),
    *(("mma", f"gemma3-4b 8/4 Dh256 T={T} n_past=0 window={w}", (8, 4), 256, T, 0,
       dict(window=w)) for T, w in ((512, 1024), (512, 0), (1500, 1024))),
    ("", "tinydoc f32 T=256 n_past=0", (4, 2), 64, 256, 0, {}),
    ("int8", "tinydoc f32 int8 T=256 n_past=256", (4, 2), 64, 256, 256, {}))
# (synth preset, layers (None: all), prompt tokens): the model phases'
# prefills, timed end to end (``prefill_times``)
PREFILL_CASES = (("8b", None, 676), ("qwen3-8b-q4_k_m", None, 1499),
                 ("gemma3-4b-q4_k_m", None, 1500), ("gpt-oss-20b-q4_0", 6, 997))
PREFILL_REPEATS = 5
GROUPS = {"gemv": ("gemv",), "rqmm": ("rqmm",), "decode": ("decode_stream",),
          "k3": ("flash_decode",), "k4": ("flash_attention",), "nib4": ("qmm", "rqmm"),
          "prefill": ("gemv", "qmm", "flash_attention")}


def device_ms(fn, torch, flush, n: int = 10) -> float:
    """Device time per call of ``fn``, without the host's launch overhead:
    n calls, each after an L2 flush (``flush`` zeroed: the decode path
    finds its weights cold), are captured in a CUDA graph and replayed; a
    graph of the n flushes alone is timed the same way and subtracted.
    Median of 3 replays, by CUDA events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graphs = []
    for with_fn in (True, False):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                flush.zero_()
                if with_fn:
                    fn()
        graphs.append(g)
    times = []
    for g in graphs:
        reps = []
        for _ in range(3):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            g.replay()
            e1.record()
            e1.synchronize()
            reps.append(e0.elapsed_time(e1))
        times.append(sorted(reps)[1])
    return (times[0] - times[1]) / n


def gemv_weights(rng, gtype: str, K: int, N: int, pad: bool, device):
    """A GEMV_CASES (or OSS_GEMV_CASES) weight: rows from ``rng``, packed
    with folded scales where the type has them."""
    from llama_cpp_gfx906_tpu_torch.gguf.constants import GGMLType
    from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as qmm
    from llama_cpp_gfx906_tpu_torch.tools import synth_gguf

    t = GGMLType[gtype]
    rows = synth_gguf._ROWS[t](rng, N, K)
    qt = qmm.pack_gguf_tensor(rows.reshape(-1), t, (N, K), fold_scales=True, device=device)
    return qmm.pad_qt_n(qt) if pad else qt


def expert_weights(gtype: str, N: int, K: int, device):
    """An EXPERT_CASES stack of ``EXPERTS`` experts (expert e's rows from
    seed [5, e])."""
    import numpy as np

    from llama_cpp_gfx906_tpu_torch.gguf.constants import GGMLType
    from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as qmm
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import q4k_rows, q8_0_rows

    t = GGMLType[gtype]
    rows = q8_0_rows if t == GGMLType.Q8_0 else q4k_rows
    raw = np.concatenate([rows(np.random.default_rng([5, e]), N, K) for e in range(EXPERTS)])
    pack = qmm.pack_gguf_experts if t == GGMLType.Q8_0 else qmm.pack_experts_int8_g16
    return pack(raw.reshape(-1), t, (EXPERTS, N, K), device=device)


def oss_experts(device, seed: int = 9):
    """gpt-oss-20b's gate experts: ``OSS_E`` Q4_0 experts of OSS_EF x OSS_D
    (expert e's rows from seed [seed, e]), packed as the loader packs them:
    split-K nib4, N padded to 3072."""
    import numpy as np

    from llama_cpp_gfx906_tpu_torch.gguf.constants import GGMLType
    from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as qmm
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import q4_0_rows

    raw = np.concatenate([q4_0_rows(np.random.default_rng([seed, e]), OSS_EF, OSS_D)
                          for e in range(OSS_E)])
    return qmm.pack_gguf_experts(raw.reshape(-1), GGMLType.Q4_0, (OSS_E, OSS_EF, OSS_D),
                                 pad_n=True, device=device)


def oss_pair_ids(rng, P: int):
    """Expert ids of P pairs: 4 distinct experts of OSS_E for each token."""
    import numpy as np

    return np.concatenate([rng.choice(OSS_E, 4, replace=False) for _ in range(P // 4)])


def oss_attn_case(torch, dev, T: int, n_past: int, window: int, seed: int) -> dict:
    """The inputs of an OSS_ATTN_CASES entry on ``dev``: q (1, T, 64, 64),
    a bf16 cache of 4096 rows of 8 KV heads, n_past, sinks (64,) and the
    window, from ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*size):
        return (torch.randn(size, generator=g, device=dev) * 0.5).to(torch.bfloat16)

    return dict(q=rnd(1, T, 64, 64), k=rnd(1, 4096, 8, 64), v=rnd(1, 4096, 8, 64),
                npast=torch.tensor([n_past], dtype=torch.int32, device=dev),
                scale=64 ** -0.5, window=window,
                sinks=torch.randn((64,), generator=g, device=dev).to(torch.bfloat16))


class RouteLog:
    """The port's MoE routes while on (``with RouteLog() as log``): per
    ``ops.moe.route`` call (one per MoE layer and forward) the chosen
    expert ids (N, k) and, per token, how far the least of their router
    logits lies below this run's own k-th largest (0 where the ids are the
    run's own top k), on the host; not for a graph capture.

    With ``replay`` (another log's ``calls``), each call takes that log's
    ids instead of its own top k, weighted by the softmax of this run's
    logits at them (gpt-oss's router, ``moe_topk_softmax``): two devices
    round the activations differently, so a router near-tie can pick
    another expert on each, and a replay holds them to one set of experts.
    The replayed ids are a valid choice for this run where each token's
    deficit is explained by the two runs' own router logits
    (:meth:`unexplained`)."""

    def __init__(self, replay: list | None = None):
        from llama_cpp_gfx906_tpu_torch.ops import moe

        self.calls, self.replay, self._moe, self._route = [], replay, moe, moe.route

    def __enter__(self):
        import torch

        def spy(logits, cfg):
            if self.replay is None:
                w, i = self._route(logits, cfg)
            else:
                if not cfg.moe_topk_softmax:
                    raise NotImplementedError("a route replay needs moe_topk_softmax")
                i = self.replay[len(self.calls)][0].to(logits.device)
                w = torch.softmax(torch.gather(logits, -1, i), -1)
            lf = logits.float()
            kth = torch.sort(lf, -1, descending=True).values[:, cfg.n_experts_used - 1]
            least = torch.gather(lf, -1, i).min(-1).values
            self.calls.append((i.cpu(), (kth - least).cpu(), lf.cpu()))
            return w, i

        self.calls = []
        self._moe.route = spy
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route

    def deficit(self) -> float:
        """The largest deficit over every routed token of every call."""
        return max(float(d.max()) for _, d, _ in self.calls)

    def margin(self) -> float:
        """The least gap, over every routed token of every call, between
        its k-th and (k+1)-th router logit: how far the run is from a
        near-tie."""
        import torch

        gaps = []
        for i, _, lf in self.calls:
            top = torch.sort(lf, -1, descending=True).values
            gaps.append(float((top[:, i.shape[-1] - 1] - top[:, i.shape[-1]]).min()))
        return min(gaps)

    def replaced(self) -> int:
        """The tokens (over every call) whose experts were not this run's
        own top k."""
        return sum(int((d > 0).sum()) for _, d, _ in self.calls)

    def unexplained(self, source: "RouteLog") -> float:
        """For a replay of ``source``: the largest ratio, over the tokens
        whose replayed experts were not this run's own top k, of the
        deficit to twice the largest difference between the two runs'
        logits of that token.  A source that ranked expert e above e' while
        this run ranks e' higher by d had logits apart by at least d / 2 at
        e or e', so a ratio above 1 is a route no rounding explains; 0 where
        every route was this run's own."""
        worst = 0.0
        for (_, d, la), (_, _, ls) in zip(self.calls, source.calls):
            rows = d > 0
            if rows.any():
                gap = 2 * (la[rows] - ls[rows]).abs().amax(-1)
                worst = max(worst, float((d[rows] / gap.clamp(min=1e-30)).max()))
        return worst


def pair_ids(rng, P: int):
    """Expert ids of P pairs: two distinct experts for each token."""
    import numpy as np

    return np.concatenate([rng.choice(EXPERTS, 2, replace=False) for _ in range(P // 2)])


def decode_engine(tmp: str, preset: str, n_layers, **synth):
    """An ``Engine`` on a DECODE_CASES stack (vocab 512, 4096 rows), and
    the GGUF's path; None where this checkout's synth lacks the preset."""
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
    from llama_cpp_gfx906_tpu_torch.tools import synth_gguf

    if preset not in synth_gguf.PRESETS:
        return None, None
    path = synth_gguf.write_synth(f"{tmp}/{preset}-kernel.gguf", preset, seed=0,
                                  n_layers=n_layers, n_vocab=512, **synth)
    return Engine.from_gguf(path, max_seq=4096), path


@functools.lru_cache(maxsize=None)
def ladder_positions(n: int, ga_n: int, ga_w: int) -> tuple:
    """The logical positions of ``n`` prefilled rows after the self-extend
    ladder that runs before the first new token (``tools/cli.ladder``), and
    that token's position: the ladder's ``seq_add`` / ``seq_div`` run
    against an ``Engine`` on the CPU (the ``tiny`` synthetic model)."""
    import torch

    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
    from llama_cpp_gfx906_tpu_torch.tools.cli import ladder
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

    with tempfile.TemporaryDirectory() as tmp:
        eng = Engine.from_gguf(write_synth(f"{tmp}/tiny.gguf", "tiny", seed=0), max_seq=n,
                               dtype=torch.float32, device="cpu")
    eng.set_n_past(n)
    for name, args in ladder(n, 0, ga_n, ga_w)[0]:
        getattr(eng, name)(*args)
    return eng.kv.pos[0].numpy().copy(), int(eng.kv.pos_next[0])


def k3_case(torch, dev, spec, seed: int) -> dict:
    """The inputs of the ``K3_CASES`` entry ``spec`` on ``dev``, from
    ``seed``: a dict of its mode, case, q, k, v, n_past, scale and the
    wrapper's keyword arguments."""
    from llama_cpp_gfx906_tpu_torch.ops.kv_quant import quantize_rows

    mode, case, (Hq, Hkv), n_past, T, opts = spec
    D, S, B = opts.get("D", 128), opts.get("S", 4096), len(n_past)
    g = torch.Generator(device=dev).manual_seed(seed)
    i32 = dict(dtype=torch.int32, device=dev)

    def rnd(*size):
        return (torch.randn(size, generator=g, device=dev) * 0.5).to(torch.bfloat16)

    q, k, v = rnd(B, T, Hq, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    if "int8" in mode:
        k, v = quantize_rows(k.float()), quantize_rows(v.float())
    npast = torch.tensor(n_past, **i32)
    kw = {}
    if "S0" in opts:
        kw.update(shared_k=rnd(1, opts["S0"], Hkv, D), shared_v=rnd(1, opts["S0"], Hkv, D))
    if "alibi" in mode:
        from llama_cpp_gfx906_tpu_torch.ops.attention import alibi_slopes_for

        kw["alibi_slopes"] = alibi_slopes_for(Hq).to(dev)
    if "softcap" in opts:
        kw["logit_softcap"] = opts["softcap"]
    if "window" in opts:
        kw["sliding_window"] = opts["window"]
    if "pos" in opts:
        t = torch.arange(T, **i32)
        if opts["pos"][0] == "div":
            grp = opts["pos"][1]
            kv_pos = (torch.arange(S, **i32) // grp)[None].expand(B, S)
            q_pos = (npast[:, None] + t[None]) // grp
        else:  # one slot whose T new rows follow the ladder's prompt
            n = n_past[0]
            lad, nxt = ladder_positions(n + T - 1, *opts["pos"][1:])
            kv_pos = torch.full((1, S), 1 << 30, **i32)
            kv_pos[0, :n] = torch.from_numpy(lad[:n]).to(dev)
            q_pos = (nxt + t)[None]
            kv_pos[0, n:n + T] = q_pos[0]
        kw.update(kv_pos=kv_pos.contiguous(), q_pos=q_pos.to(torch.int32).contiguous())
    return dict(mode=mode, case=case, q=q, k=k, v=v, npast=npast, scale=D ** -0.5, kw=kw)


def k4_case(torch, dev, spec, seed: int) -> dict:
    """The inputs of the ``K4_CASES`` entry ``spec`` on ``dev``, from
    ``seed``: a dict of its name (the wrapper's count name), mode, case,
    the wrapper's arguments and keywords, the (T, keys) mask of live
    pairs, the bytes (q in, out, each live row once; int8 with its two
    scales) and flops (4 D per live pair and query head) of the bound, and
    ``sdpa``: SDPA on the same rows (an int8 cache dequantized to bf16
    beforehand) with the boolean mask, without sinks."""
    import torch.nn.functional as F

    from llama_cpp_gfx906_tpu_torch.ops.kv_quant import dequantize_rows, quantize_rows

    mode, case, (Hq, Hkv), D, T, n_past, opts = spec
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.bfloat16 if "mma" in mode else torch.float32
    int8 = "int8" in mode

    def rnd(*size):
        return torch.randn(size, generator=g, device=dev).to(dt)

    q, k, v = rnd(1, T, Hq, D), rnd(1, 4096, Hkv, D), rnd(1, 4096, Hkv, D)
    window = opts.get("window", 0)
    sinks = torch.randn((Hq,), generator=g, device=dev) if opts.get("sinks") else None
    kw, kd, vd = {}, k, v
    if int8:
        kq, vq = quantize_rows(k.float()), quantize_rows(v.float())
        kd, vd = dequantize_rows(kq, dt), dequantize_rows(vq, dt)
        k, v = kq.q, vq.q
        kw = dict(k_scales=kq.s[..., 0], v_scales=vq.s[..., 0])
    npast = torch.tensor([n_past], dtype=torch.int32, device=dev)
    qpos = n_past + torch.arange(T, device=dev)[:, None]
    keys = torch.arange(n_past + T, device=dev)[None, :]
    seen = (keys <= qpos) & ((keys > qpos - window) if window else True)
    live = int(seen.any(0).sum())
    row = Hkv * (2 * D + 2 * 4) if int8 else Hkv * 2 * D * q.element_size()
    qs = q.transpose(1, 2).contiguous()
    kl = kd[:, :n_past + T].transpose(1, 2).contiguous()
    vl = vd[:, :n_past + T].transpose(1, 2).contiguous()
    return dict(
        name="flash_attention" + (f"_{mode}" if mode else ""), mode=mode, case=case,
        args=(q, k, v, npast, D ** -0.5, window, 0.0, sinks), kw=kw, seen=seen,
        nbytes=2 * q.numel() * q.element_size() + live * row,
        flops=4 * D * Hq * int(seen.sum()),
        sdpa=lambda: F.scaled_dot_product_attention(qs, kl, vl, attn_mask=seen,
                                                    scale=D ** -0.5, enable_gqa=True))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout whose package to time")
    ap.add_argument("--label", default="")
    ap.add_argument("--splits", action="store_true",
                    help="also time K1 / K2 at every split count")
    ap.add_argument("--kernels", default=",".join(GROUPS),
                    help=f"the groups to build and time, of {','.join(GROUPS)}")
    args = ap.parse_args(argv)
    groups = args.kernels.split(",")
    sys.path.insert(0, args.root)
    import numpy as np
    import torch

    from llama_cpp_gfx906_tpu_torch import kernels
    from llama_cpp_gfx906_tpu_torch.models.llama import KVCache, embed
    from llama_cpp_gfx906_tpu_torch.ops import decode_step as k7
    from llama_cpp_gfx906_tpu_torch.ops import decode_stream as k6
    from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as qmm

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    if Path(kernels.__file__).resolve().parents[1] != Path(args.root).resolve():
        raise SystemExit(f"kernel_times: imported {kernels.__file__}, not {args.root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(card=smi, root=args.root, label=args.label)), flush=True)
    for group in groups:
        t0 = time.perf_counter()
        kernels.build_all(GROUPS[group])
        print(json.dumps(dict(label=args.label, build=group,
                              seconds=time.perf_counter() - t0)), flush=True)
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)

    def emit(kernel, case, ms, **extra):
        print(json.dumps(dict(label=args.label, kernel=kernel, case=case, ms=ms, **extra)),
              flush=True)

    for name, case, gtype, K, N, pad in GEMV_CASES if "gemv" in groups else ():
        qt = gemv_weights(rng, gtype, K, N, pad, dev)
        x = torch.randn((1, K), generator=g, device=dev).to(torch.bfloat16)
        kern = getattr(qmm, name)
        emit(name, case, device_ms(lambda: kern(x, qt), torch, flush))
        if args.splits and hasattr(qmm, "gemv_splits"):
            seg, _ = qmm._gemv_segment(qt)
            nseg = (K // 2 if qt.fmt == "nib4c" else K) // seg
            for d in (d for d in range(1, nseg + 1) if nseg % d == 0):
                emit(name, case, device_ms(lambda: qmm._gemv_launch(x, qt, d), torch, flush),
                     splits=d)
        del qt

    prng = np.random.default_rng(5)
    for case, gtype, N, K, pairs in EXPERT_CASES if "rqmm" in groups else ():
        qt = expert_weights(gtype, N, K, dev)
        for P in pairs:
            idx = torch.tensor(pair_ids(prng, P), dtype=torch.int32, device=dev)
            x = torch.randn((P, K), generator=g, device=dev).to(torch.bfloat16)
            emit("rqmm_int8", f"{case} P={P}", device_ms(lambda: qmm.rqmm_int8(x, qt, idx),
                                                         torch, flush))
        del qt
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        for name, preset, L, batches, synth in DECODE_CASES if "decode" in groups else ():
            eng, path = decode_engine(tmp, preset, L, **synth)
            if eng is None:
                emit(name, preset, None, left_out="no such preset in this checkout")
                continue
            cfg, params = eng.cfg, eng.params
            k7_route = name.startswith("decode_step")
            kern = k7.fused_decode_step if k7_route else k6.fused_decode_step_streamed
            gate = k7._fused_ok if k7_route else k6._stream_ok
            for B in batches:
                kv = KVCache.create(cfg, B, 4096, torch.bfloat16, dev)
                if not gate(params, cfg, kv, B, 1):
                    emit(name, f"{preset} B={B}", None, left_out="the gate refuses it")
                    continue
                kv.k.copy_(torch.randn(kv.k.shape, generator=g, device=dev))
                kv.v.copy_(torch.randn(kv.v.shape, generator=g, device=dev))
                kv.n_past.fill_(3000)
                x = embed(params, cfg, torch.randint(0, cfg.n_vocab, (B, 1), generator=g,
                                                     device=dev))
                with torch.inference_mode():
                    ms = device_ms(lambda: kern(params, cfg, x, kv), torch, flush)
                emit(name, f"{preset} L={cfg.n_layers} B={B} n_past=3000", ms)
                del kv
            del eng, params
            Path(path).unlink()
            torch.cuda.empty_cache()
    if "k3" in groups:
        k3_times(torch, dev, flush, emit)
    if "k4" in groups:
        k4_times(torch, dev, flush, emit)
    if "nib4" in groups:
        nib4_times(torch, dev, flush, emit)
    if "prefill" in groups:
        prefill_times(torch, emit)


def nib4_times(torch, dev, flush, emit) -> None:
    """K5-nib4 on QMM_NIB4_CASES and K8-nib4 on RQMM_NIB4_CASES (gpt-oss's
    gate experts, inputs from seeds 11 and 12), where the checkout has
    them."""
    import numpy as np

    from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as qmm

    if not hasattr(qmm, "qmm_nib4"):
        emit("qmm_nib4", "gpt-oss", None, left_out="no nib4 mode in this checkout")
        return
    qt = oss_experts(dev)
    e0 = qmm.qt_expert(qt, 0)
    g = torch.Generator(device=dev).manual_seed(11)
    for case, M in QMM_NIB4_CASES:
        x = torch.randn((M, OSS_D), generator=g, device=dev).to(torch.bfloat16)
        emit("qmm_nib4", case, device_ms(lambda: qmm.qmm_nib4(x, e0), torch, flush))
    rng = np.random.default_rng(12)
    for case, P in RQMM_NIB4_CASES:
        idx = torch.tensor(oss_pair_ids(rng, P), dtype=torch.int32, device=dev)
        x = torch.randn((P, OSS_D), generator=g, device=dev).to(torch.bfloat16)
        emit("rqmm_nib4", case, device_ms(lambda: qmm.rqmm_nib4(x, qt, idx), torch, flush))


def k3_times(torch, dev, flush, emit) -> None:
    """K3 on ``K3_CASES`` (inputs from seed 17 + the case's index), each
    case whose mode the checkout's K3 has."""
    from llama_cpp_gfx906_tpu_torch.ops.flash_decode import flash_decode

    for i, spec in enumerate(K3_CASES):
        if spec[0] and spec[0] not in flash_decode.modes:
            emit("flash_decode", spec[1], None, left_out="no such mode in this checkout")
            continue
        c = k3_case(torch, dev, spec, 17 + i)
        args = (c["q"], c["k"], c["v"], c["npast"], c["scale"])
        emit("flash_decode", c["case"],
             device_ms(lambda: flash_decode(*args, **c["kw"]), torch, flush), mode=c["mode"])
        del c, args
        torch.cuda.empty_cache()


def k4_times(torch, dev, flush, emit) -> None:
    """K4 on ``K4_CASES`` (inputs from seed 60 + the case's index), through
    whichever body the checkout's wrapper takes for the case's dtypes (a
    checkout without the ``mma`` mode has one body for both), each case
    with the launch counts its call added."""
    from llama_cpp_gfx906_tpu_torch import kernels
    from llama_cpp_gfx906_tpu_torch.ops.flash_attention import flash_attention

    for i, spec in enumerate(K4_CASES):
        c = k4_case(torch, dev, spec, 60 + i)
        before = kernels.counts()
        flash_attention(*c["args"], **c["kw"])
        counted = sorted(k for k, n in kernels.counts().items() if n != before[k])
        emit(c["name"], c["case"],
             device_ms(lambda: flash_attention(*c["args"], **c["kw"]), torch, flush),
             mode=c["mode"], counted=counted)
        del c
        torch.cuda.empty_cache()


def prefill_times(torch, emit) -> None:
    """``Engine.prefill`` of each ``PREFILL_CASES`` prompt (random token
    ids from seed 0) ``PREFILL_REPEATS`` times after one warm-up, by the
    host's clock between two synchronizations, with the launch counts of
    one prefill; synthetic weights from seed 0, written once under this
    script's checkout (``build/prefill_ggufs``) and reused by later runs
    and by other ``--root``s.  One prefill's time moves by tens of percent
    from run to run on some models: alternate the checkouts compared."""
    import statistics

    import numpy as np

    from llama_cpp_gfx906_tpu_torch import kernels
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

    gguf_dir = Path(__file__).resolve().parents[2] / "build" / "prefill_ggufs"
    gguf_dir.mkdir(parents=True, exist_ok=True)
    for preset, n_layers, n in PREFILL_CASES:
        path = gguf_dir / f"{preset}-{n_layers or 'all'}.gguf"
        if not path.exists():
            write_synth(str(path), preset, seed=0, n_layers=n_layers)
        eng = Engine.from_gguf(str(path), max_seq=4096)
        ids = [int(t) for t in np.random.default_rng(0).integers(3, eng.cfg.n_vocab, n)]
        times = []
        for i in range(PREFILL_REPEATS + 1):
            eng.reset()
            kernels.set_counts({})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.prefill(ids)
            torch.cuda.synchronize()
            if i:  # the first is the warm-up
                times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        emit("prefill", f"{preset} L={eng.cfg.n_layers} T={n}", med * 1e3, tok_s=n / med,
             times_s=times, launches={k: v for k, v in kernels.counts().items() if v})
        del eng
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
