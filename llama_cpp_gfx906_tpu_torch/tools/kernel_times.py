"""Device times of the split-K kernels, K1 / K2, K3, K4, K5 and the nib4 modes, at the main paths' shapes.

The cases live here, and ``chip_smoke.py`` builds its kernel cases from the
same lists: K1 / K2 (``GEMV_CASES``: the 8B head, ``attn_v`` and Q4_K
projections; ``OSS_GEMV_CASES`` at gpt-oss-20b's shapes; each at M 1, 4
and 8 rows of x, ``GEMV_MS``), K8 (``EXPERT_CASES``: Mixtral's experts at 2
and 8 pairs) and K6 / K7 in each mode (``DECODE_CASES``: a few full-width
layers of each model, or a small model's whole stack) and K3 in each mode
(``K3_CASES``: the 8B's, MPT-7B's, BLOOM-7B1's, tinydoc's, the Qwen
group sizes', gpt-oss's and Gemma-3-4B's heads and the JAX tests' shape;
:func:`k3_case` makes their inputs) and K4 in each mode
(``K4_CASES``: every prefill shape of the model phases; :func:`k4_case`
makes their inputs) and K5 in both modes (``QMM_CASES``: the 270M Q8_0,
Gemma-3-4B, Mixtral Q8_0 and gpt-oss-20b prefill projections;
:func:`qmm_case` makes their inputs); at gpt-oss-20b's shapes, K8's nib4
mode (``RQMM_NIB4_CASES`` on :func:`oss_experts`) and K3 with sinks
(``OSS_ATTN_CASES``).
Each is timed as ``chip_smoke.py`` times a kernel (:func:`device_ms`).
The ``prefill`` group times the model phases' whole prefills instead
(``PREFILL_CASES``, :func:`prefill_times`), and the ``loop`` group whole
decode tokens (``LOOP_CASES``: MPT-7B and BLOOM-7B1's ``decode_fused``
through K1 / K2, the 8B's, Gemma-3-4B's and Qwen3-8B's through K6, and the
8B's 4-slot batched step with a q8 cache (the loop) and a bf16 one (K6),
:func:`loop_times`), by the host's clock.
Synthetic weights from seed 0; caches of random rows filled to n_past
3000.  With ``--splits``, K1 / K2 and K5 are also timed at every tile and
split count the kernel takes (``gemv_config`` and ``qmm_config`` pick one
of them).  ``--variant`` times a copy of the package with one of
``VARIANTS``' edits: to K1 / K2 (``stream_only``: the ring's stream
alone), or to K6 / K7 (``k6_trace``: each block stamps ``%globaltimer`` at
its start and at each grid barrier's arrival and release; the ``decode``
group then adds each case's ``trace``, :func:`decode_trace`).  The ``decode``
group times each case at n_past 700 and 3000 with the per-layer loop's
device time on the same step beside it (``loop_ms``, as ``chip_smoke.py``
times it).  ``--kernels`` picks the groups to build and time (default all);
the wall time of each build is printed.

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

# the rows of x of every GEMV case: one stream, the 4-slot served step, the
# most rows a served step takes
GEMV_MS = (1, 4, 8)


def _with_ms(shapes):
    """(kernel, case + " M=<M>", GGML type, K, N, padded, M) for each shape
    and each of GEMV_MS."""
    return tuple((k, f"{case} M={M}", *rest, M) for k, case, *rest in shapes for M in GEMV_MS)


# (kernel, case, GGML type, K, N, N padded to whole 2048-column blocks, M)
GEMV_CASES = _with_ms((
    ("gemv_int8", "lm_head 4096x129024", "Q6_K", 4096, 128256, True),
    ("gemv_int8", "attn_v 4096x1024", "Q6_K", 4096, 1024, False),
    ("gemv_nib4c", "attn_qk 4096x5120", "Q4_K", 4096, 5120, False),
    ("gemv_nib4c", "attn_output 4096x4096", "Q4_K", 4096, 4096, False),
    ("gemv_nib4c", "ffn_gate_up 4096x28672", "Q4_K", 4096, 28672, False),
    ("gemv_nib4c", "ffn_down 14336x4096", "Q4_K", 14336, 4096, False)))
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
# :func:`ladder_positions`), ``softcap``, ``window``, ``sinks`` (a logit
# per query head, randn * 2).  The old modes at
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
     dict(_JAX_SHAPE, pos=("div", 3), window=32)),
    # the 8B over 8192 rows, full and with window 1024 and sinks; the serve
    # modes at the 8B's and tinydoc's heads (4 slots); the Qwen group sizes;
    # gpt-oss's 64/8 heads of 64 with sinks (``OSS_ATTN_CASES``), also over
    # int8 rows, and sinks after shared rows (the planted sink fault's cases);
    # Gemma-3-4B's 8/4 heads of 256 (query tiles of 4): its served q8 step
    # (4 slots, full and in the local layers' window of 1024) and one bf16
    # stream in that window
    *(("", f"8b B=1 bf16 S=8192 n_past={n} window={w}{' sinks' if w else ''}", (32, 8),
       (n,), 1, dict(S=8192, window=w, sinks=True) if w else dict(S=8192))
      for w in (0, 1024) for n in (17, 3000, 8000)),
    *((mode, f"{shape} B=4 {kind}", heads, n_past, 1, dict(opts, D=D))
      for shape, heads, D in (("8b", (32, 8), 128), ("tinydoc", (4, 2), 64))
      for mode, kind, n_past, opts in (
          ("int8", "int8 n_past=17/700/1500/3000", (17, 700, 1500, 3000), {}),
          ("shared", "bf16 S0=512 n_past=700", (700,) * 4, dict(S0=512)),
          ("int8_shared", "int8 S0=512 n_past=700", (700,) * 4, dict(S0=512)))
      if (shape, mode) != ("8b", "shared")),  # that one is the third case
    *((i8, f"{shape} {kind} T=1 n_past={n}", heads, (n,), 1, {})
      for shape, heads in (("G7 28/4", (28, 4)), ("G8 32/4", (32, 4)))
      for i8, kind in (("", "bf16"), ("int8", "int8")) for n in (700, 3000)),
    *(("", f"gpt-oss 64/8 Dh64 sinks T=1 n_past={n} window={w}", (64, 8), (n,), 1,
       dict(D=64, sinks=True, window=w)) for n in (700, 3000) for w in (128, 0)),
    ("int8", "gpt-oss 64/8 Dh64 int8 sinks T=1 n_past=700 window=128", (64, 8), (700,), 1,
     dict(D=64, sinks=True, window=128)),
    ("shared", "8b B=4 bf16 S0=512 n_past=100 window=256 sinks", (32, 8), (100,) * 4, 1,
     dict(S0=512, window=256, sinks=True)),
    *(("int8", f"gemma3-4b 8/4 Dh256 B=4 int8 n_past=256/700/1500/3000 window={w}", (8, 4),
       (256, 700, 1500, 3000), 1, dict(D=256, window=w)) for w in (0, 1024)),
    ("", "gemma3-4b 8/4 Dh256 B=1 bf16 n_past=3000 window=1024", (8, 4), (3000,), 1,
     dict(D=256, window=1024)))
# gpt-oss-20b: Q4_0 experts (32), K = D = 2880, the expert FF 2880 padded
# to 3072 (gate and up: split-K nib4, no nib4c chunk at 2880)
OSS_D, OSS_EF, OSS_E = 2880, 2880, 32
# (case, P): K8-nib4 on the gate experts for one token's 4 pairs and two
# tokens' 8, distinct experts per token, with mins (Q4_0: m = 8 d)
RQMM_NIB4_CASES = tuple((f"gate 2880x3072 with mins P={P}", P) for P in (4, 8))
# K1 at K 2880 (q|k|v with mins, the head's 2880 rows) and K2 at N 2880
OSS_GEMV_CASES = _with_ms((
    ("gemv_int8", "attn_qkv 2880x5120 with mins", "Q4_0", 2880, 5120, False),
    ("gemv_int8", "lm_head 2880x201088", "Q8_0", 2880, 201088, True),
    ("gemv_nib4c", "attn_output 4096x2880", "Q4_0", 4096, 2880, False)))
# (mode, case, GGML type, K, N, M): K5 at the prefill shapes of the model
# phases, x of M rows: the 270M Q8_0 projections at its 676-token prompt;
# Gemma-3-4B's attn_v (Q6_K: int8 planes, group 16) at a served chunk of
# 256; a Mixtral Q8_0 expert's gate and down at one served chunk (every
# expert runs on every token of a prefill chunk); gpt-oss-20b's fused
# q|k|v (Q4_0 at K 2880: int8 with mins) at its ragged chunk and prompt,
# and one gate expert (Q4_0, split-K nib4 with mins, N 2880 stored as
# 3072) at M 101 / 256 / 1000
QMM_CASES = (
    *(("int8", f"270m {name} {K}x{N} M=676", "Q8_0", K, N, 676)
      for name, K, N in (("attn_qkv", 640, 1536), ("attn_output", 1024, 640),
                         ("ffn_gate_up", 640, 4096), ("ffn_down", 2048, 640))),
    ("int8", "gemma3-4b attn_v 2560x1024 g16 M=256", "Q6_K", 2560, 1024, 256),
    ("int8", "mixtral expert ffn_gate 4096x14336 M=256", "Q8_0", 4096, 14336, 256),
    ("int8", "mixtral expert ffn_down 14336x4096 M=256", "Q8_0", 14336, 4096, 256),
    *(("int8", f"gpt-oss attn_qkv 2880x5120 with mins M={M}", "Q4_0", 2880, 5120, M)
      for M in (101, 1000)),
    *(("nib4", f"gpt-oss gate 2880x3072 with mins M={M}", "Q4_0", OSS_D, OSS_EF, M)
      for M in (101, 256, 1000)))
# (kernel, case, T, n_past, window): the bf16 ``K3_CASES`` at gpt-oss's 64/8
# heads of 64 with sinks, window 128 (the even layers) and full, one slot
# of 4096 rows (K4's gpt-oss cases are in ``K4_CASES``)
OSS_ATTN_CASES = tuple(("flash_decode", case, T, n_past[0], opts["window"])
                       for mode, case, _, n_past, T, opts in K3_CASES
                       if case.startswith("gpt-oss") and not mode)
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
                 ("gemma3-4b-q4_k_m", None, 1500), ("gpt-oss-20b-q4_0", 6, 997),
                 ("270m-q8_0", None, 676), ("mixtral-q8_0", 4, 676))
PREFILL_REPEATS = 5
# (synth preset, layers (None: all)): the ``loop`` group's single-stream
# models, timed through ``decode_fused`` (the per-layer loop in a graph)
LOOP_CASES = (("mpt-7b-q4_k_m", None), ("bloom-7b1-q4_k_m", 4), ("8b", None),
              ("gemma3-4b-q4_k_m", None), ("qwen3-8b-q4_k_m", None))
LOOP_PROMPT, LOOP_STEPS, LOOP_REPEATS = 256, 64, 5
LOOP_SERVE_LENS = (700, 800, 900, 1000)  # the 8B 4-slot q8 step's prompts
DECODE_N_PAST = (700, 3000)  # the decode group's steps
GROUPS = {"gemv": ("gemv",), "rqmm": ("rqmm",),
          "decode": ("decode_stream", "gemv", "flash_decode", "flash_attention", "qmm"),
          "k3": ("flash_decode",), "k4": ("flash_attention",), "k5": ("qmm",),
          "nib4": ("rqmm",), "prefill": ("gemv", "qmm", "flash_attention"),
          "loop": ("gemv", "flash_decode", "flash_attention", "qmm", "decode_stream")}


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


def gemv_by_shape(cases) -> list:
    """GEMV cases grouped by their weight, in order: [((GGML type, K, N,
    padded), [case, ...]), ...], so each weight is made once."""
    groups: dict = {}
    for c in cases:
        groups.setdefault(tuple(c[2:6]), []).append(c)
    return list(groups.items())


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


def qmm_case(torch, dev, spec, seed: int) -> dict:
    """The inputs of the ``QMM_CASES`` entry ``spec`` on ``dev``, from
    ``seed``: a dict of its count name, mode, case, x (M, K) bf16, the
    weight (int8: the GGUF rows of its type, packed as the loader packs
    them; nib4: one gpt-oss gate expert, ``oss_experts``' packing), the
    kernel call as the main path makes it (``quant_matmul``: bf16 out) and
    the wrapper's own (``qmm_<mode>``: f32 out), the plain call (bf16 out),
    the library call (``torch.matmul`` on the weight dequantized to bf16
    beforehand), and the bound's bytes (x, the packed bytes, scales and
    mins once, the bf16 output) and flops (2 M K N)."""
    import numpy as np

    from llama_cpp_gfx906_tpu_torch.gguf.constants import GGMLType
    from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as qmm
    from llama_cpp_gfx906_tpu_torch.tools import synth_gguf

    mode, case, gtype, K, N, M = spec
    t = GGMLType[gtype]
    rng = np.random.default_rng(seed)
    if mode == "nib4":
        raw = synth_gguf.q4_0_rows(rng, N, K)
        qt = qmm.qt_expert(qmm.pack_gguf_experts(raw.reshape(-1), t, (1, N, K), pad_n=True,
                                                 device=dev), 0)
    else:
        qt = qmm.pack_gguf_tensor(synth_gguf._ROWS[t](rng, N, K).reshape(-1), t, (N, K),
                                  device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    w = qmm.dequantize_qt(qt, torch.bfloat16)
    wrapper = getattr(qmm, f"qmm_{mode}")
    plain = qmm.qmm_plain
    nbytes = (x.numel() * 2 + M * N * 2 + sum(p.numel() * p.element_size()
                                              for p in (qt.q, qt.s, qt.m) if p is not None))
    return dict(name=f"qmm_{mode}", mode=mode, case=case, x=x, qt=qt,
                kern=lambda: qmm.quant_matmul(x, qt), wrapper=lambda: wrapper(x, qt),
                plain=lambda: plain(x, qt).to(torch.bfloat16), lib=lambda: torch.matmul(x, w),
                nbytes=nbytes, flops=2 * M * K * N)


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
    if opts.get("window"):
        kw["sliding_window"] = opts["window"]
    if opts.get("sinks"):
        kw["sinks"] = torch.randn((Hq,), generator=g, device=dev) * 2
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
                    help="also time K1 / K2 and K5 at every tile and split count")
    ap.add_argument("--kernels", default=",".join(GROUPS),
                    help=f"the groups to build and time, of {','.join(GROUPS)}")
    ap.add_argument("--cases", default="",
                    help="the decode group's synth presets to time (default: every case's)")
    ap.add_argument("--variant", choices=sorted(VARIANTS),
                    help="time a copy of --root's package with this K1 / K2 or K6 / K7 variant")
    args = ap.parse_args(argv)
    groups = args.kernels.split(",")
    if args.variant:
        args.root = str(variant_root(Path(args.root), args.variant))
    sys.path.insert(0, args.root)
    import numpy as np
    import torch

    from llama_cpp_gfx906_tpu_torch import kernels
    from llama_cpp_gfx906_tpu_torch.models.llama import KVCache, embed, layers_forward
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

    def emit(kernel, case, ms, **extra):
        print(json.dumps(dict(label=args.label, kernel=kernel, case=case, ms=ms, **extra)),
              flush=True)

    if "gemv" in groups:
        gemv_times(torch, dev, flush, emit, args.splits)

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
            if args.cases and preset not in args.cases.split(","):
                continue
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
                x = embed(params, cfg, torch.randint(0, cfg.n_vocab, (B, 1), generator=g,
                                                     device=dev))
                for n_past in DECODE_N_PAST:
                    kv.n_past.fill_(n_past)
                    with torch.inference_mode():
                        ms = device_ms(lambda: kern(params, cfg, x, kv), torch, flush)
                        loop_ms = device_ms(lambda: layers_forward(params, cfg, x, kv), torch,
                                            flush)
                        extra = {}
                        if args.variant == "k6_trace":
                            extra["trace"] = decode_trace(torch, k6, flush,
                                                          lambda: kern(params, cfg, x, kv))
                    emit(name, f"{preset} L={cfg.n_layers} B={B} n_past={n_past}", ms,
                         loop_ms=loop_ms, **extra)
                del kv
            del eng, params
            Path(path).unlink()
            torch.cuda.empty_cache()
    if "k3" in groups:
        k3_times(torch, dev, flush, emit)
    if "k4" in groups:
        k4_times(torch, dev, flush, emit)
    if "k5" in groups:
        k5_times(torch, dev, flush, emit, args.splits)
    if "nib4" in groups:
        nib4_times(torch, dev, flush, emit)
    if "prefill" in groups:
        prefill_times(torch, emit)
    if "loop" in groups:
        loop_times(torch, emit)


def gemv_times(torch, dev, flush, emit, sweep: bool) -> None:
    """K1 / K2 on GEMV_CASES and OSS_GEMV_CASES (weights from seed 0 in
    order, x from seed 0): ``ms`` the call the main path makes
    (``quant_matmul`` on a bf16 x: this checkout's kernel and whatever it
    launches beside it), ``matmul_ms`` one ``torch.matmul`` of x and the
    weight dequantized to bf16 beforehand (the yardstick), the launch
    counts of one call and, where the checkout has
    ``gemv_config``, the block's columns and splits; with ``sweep``, at M 1
    every tile width and split count the launcher takes."""
    import numpy as np

    from llama_cpp_gfx906_tpu_torch import kernels
    from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as qmm

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev).manual_seed(0)
    for (gtype, K, N, pad), cases in gemv_by_shape((*GEMV_CASES, *OSS_GEMV_CASES)):
        qt = gemv_weights(rng, gtype, K, N, pad, dev)
        w = qmm.dequantize_qt(qt, torch.bfloat16)
        kp, Np = qt.q.shape
        for name, case, *_, M in cases:
            x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
            before = kernels.counts()
            qmm.quant_matmul(x, qt)
            counted = {k: n - before[k] for k, n in kernels.counts().items() if n != before[k]}
            extra = {}
            if hasattr(qmm, "gemv_config"):
                extra["tn"], extra["splits"] = qmm.gemv_config(kp, Np, sms)
            emit(name, case, device_ms(lambda: qmm.quant_matmul(x, qt), torch, flush),
                 matmul_ms=device_ms(lambda: torch.matmul(x, w), torch, flush),
                 counted=counted, **extra)
            if sweep and "splits" in extra and M == 1:
                for tn in qmm.GEMV_TILES:
                    for sp in range(1, min(qmm.GEMV_MAX_SPLITS, kp // qmm.GEMV_STAGE) + 1):
                        emit(name, case, device_ms(
                            lambda: qmm._gemv_launch(x, qt, torch.float32, tn, sp), torch,
                            flush), tn=tn, splits=sp)
        del qt, w
        torch.cuda.empty_cache()


# Variants of K1 / K2 that find what binds them, made by ``--variant``:
# (file under the package, text, what replaces it) each.  "stream_only": the
# consumer warps wait on each ring stage and free it without reading it, so
# the launch times the producer's TMA stream, the prologue and the merge
GEMV_VARIANTS = {
    "stream_only": (
        ("csrc/gemv.cu", "for (int r = 0; r < RUNS; ++r) {\n        float d[H][4][4]",
         "for (int r = 0; r < 0; ++r) {\n        float d[H][4][4]"),
        ("csrc/gemv.cu", "if constexpr (FOLDED) {\n        // the stage's factors",
         "if constexpr (false) {\n        // the stage's factors")),
}


# Variants of K6 / K7: "k6_trace" compiles the phase trace in (``TRACE`` in
# csrc/decode_stream.cu: each block's %globaltimer at its start and at each
# grid barrier's arrival and release), read by :func:`decode_trace`
DECODE_VARIANTS = {
    "k6_trace": (("csrc/decode_stream.cu", "constexpr bool TRACE = false;",
                  "constexpr bool TRACE = true;"),),
}
VARIANTS = {**GEMV_VARIANTS, **DECODE_VARIANTS}
# K6 / K7's phases, one grid barrier ending each (csrc/decode_stream.cu P1-P7),
# and the trace's size (its TRACE_BARS, TRACE_BLOCKS)
TRACE_PHASES = ("qkv", "attn_max", "attn_pv", "merge", "o", "gu", "dn")
TRACE_BARS, TRACE_BLOCKS = 7 * 32, 264


def decode_trace(torch, k6, flush, fn) -> dict:
    """One launch of ``fn`` (a K6 / K7 step of a ``k6_trace`` build) after
    an L2 flush, and what its blocks stamped, summed by
    :func:`trace_summary`."""
    import ctypes

    import numpy as np

    so = k6._so()
    so.lcg_decode_trace.restype = ctypes.c_int
    so.lcg_decode_trace.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                    ctypes.POINTER(ctypes.c_longlong)]
    buf = np.zeros(TRACE_BLOCKS * (1 + 2 * TRACE_BARS), np.uint64)
    got = ctypes.c_longlong(0)
    so.lcg_decode_trace(buf.ctypes.data, buf.size, ctypes.byref(got))  # clears it
    flush.zero_()
    with torch.inference_mode():
        fn()
    torch.cuda.synchronize()
    so.lcg_decode_trace(buf.ctypes.data, buf.size, ctypes.byref(got))
    if got.value == 0:
        return {"left_out": "not a trace build"}
    return trace_summary(buf.reshape(TRACE_BLOCKS, -1).astype(np.int64))


def trace_summary(rows) -> dict:
    """The trace's rows (a block each: its start, then each barrier's
    arrival and release, ns; rows of blocks that did not run are 0) per
    phase, summed over the layers: ``work_us``, a block's average time from
    the last barrier's release to its arrival at the phase's barrier (its
    share of the phase); ``wait_us``, its average time in that barrier;
    ``span_us``, from the last block's release out of the previous barrier
    to the last block's release out of this one; and ``barrier_us``, the
    last block's arrival to its release (the barrier's own latency).  And
    the step's span, first start to last release."""
    import numpy as np

    rows = rows[rows[:, 0] != 0]
    n = int((rows[0, 1::2] != 0).sum())  # the barriers the launch passed
    start = rows[:, 0:1]
    arrive, release = rows[:, 1:1 + 2 * n:2], rows[:, 2:2 + 2 * n:2]
    before = np.concatenate([start, release[:, :-1]], axis=1)
    last_before = np.concatenate([[start.min()], release.max(0)[:-1]])
    nb = rows.shape[0]
    out = {"step_us": float(release.max() - start.min()) / 1e3, "blocks": nb}
    for k, name in enumerate(TRACE_PHASES):
        cols = np.arange(k, n, len(TRACE_PHASES))
        out[name] = dict(
            work_us=float((arrive - before)[:, cols].sum()) / 1e3 / nb,
            wait_us=float((release - arrive)[:, cols].sum()) / 1e3 / nb,
            span_us=float((release.max(0) - last_before)[cols].sum()) / 1e3,
            barrier_us=float((release.max(0) - arrive.max(0))[cols].sum()) / 1e3)
    return out


def variant_root(root: Path, name: str) -> Path:
    """A copy of ``root``'s package with VARIANTS[name]'s edits, under
    ``root/build/variants/<name>`` (made anew): the root to time."""
    import shutil

    pkg = "llama_cpp_gfx906_tpu_torch"
    out = root / "build" / "variants" / name
    shutil.rmtree(out / pkg, ignore_errors=True)
    shutil.copytree(root / pkg, out / pkg, ignore=shutil.ignore_patterns("__pycache__"))
    for rel, text, planted in VARIANTS[name]:
        src = out / pkg / rel
        body = src.read_text()
        if body.count(text) != 1:
            raise SystemExit(f"kernel_times: variant {name}: the text to replace is not "
                             f"in {rel} once")
        src.write_text(body.replace(text, planted))
    return out


def loop_times(torch, emit) -> None:
    """End to end: per-token ``decode_fused`` time of each ``LOOP_CASES``
    model (MPT-7B at full depth and BLOOM-7B1 at 4 of 30 layers through the
    per-layer loop in a captured graph: K2 on every projection, K3's ALiBi
    mode, K1 on the head; the 8B, Gemma-3-4B and Qwen3-8B at full depth
    through K6 and K1), LOOP_STEPS tokens after a LOOP_PROMPT-token prompt,
    LOOP_REPEATS times after a warm-up (host clock between
    synchronizations), with the launches of one token as the kernels count
    them on the device; then the 8B's 4-slot decode step (``BatchedEngine``,
    LOOP_SERVE_LENS prompts, LOOP_STEPS tokens each) with a q8 cache (the
    per-layer loop) and a bf16 one (K6) by its replays' device time and its
    wall time per step.  Synthetic weights
    from seed 0, written once under this script's checkout
    (``build/prefill_ggufs``) and reused by later runs and other ``--root``s.
    One run moves by a few percent: alternate the checkouts compared."""
    import statistics

    import numpy as np

    from llama_cpp_gfx906_tpu_torch import kernels
    from llama_cpp_gfx906_tpu_torch.runtime.batch_engine import BatchedEngine, SamplerConfig
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine, load_model
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

    gguf_dir = Path(__file__).resolve().parents[2] / "build" / "prefill_ggufs"
    gguf_dir.mkdir(parents=True, exist_ok=True)

    def gguf(preset, n_layers):
        path = gguf_dir / f"{preset}-{n_layers or 'all'}.gguf"
        if not path.exists():
            write_synth(str(path), preset, seed=0, n_layers=n_layers)
        return str(path)

    for preset, n_layers in LOOP_CASES:
        eng = Engine.from_gguf(gguf(preset, n_layers), max_seq=4096)
        ids = [int(t) for t in np.random.default_rng(0).integers(3, eng.cfg.n_vocab, LOOP_PROMPT)]
        eng.reset()
        tok = int(np.argmax(eng.prefill(ids)))
        toks = eng.decode_fused(tok, n_steps=LOOP_STEPS)  # the warm-up: captures the step
        before = kernels.device_counts()
        times = []
        for _ in range(LOOP_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = eng.decode_fused(toks[-1], n_steps=LOOP_STEPS)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) / LOOP_STEPS)
        per_tok = {k: (v - before[k]) / (LOOP_STEPS * LOOP_REPEATS)
                   for k, v in kernels.device_counts().items() if v != before[k]}
        med = statistics.median(times)
        emit("decode_fused", f"{preset} L={eng.cfg.n_layers}", med * 1e3, tok_s=1 / med,
             times_ms=[t * 1e3 for t in times], launches_per_token=per_tok)
        del eng
        torch.cuda.empty_cache()

    dev = torch.device("cuda")
    cfg, params, tok = load_model(gguf("8b", None), torch.bfloat16, dev)
    for cache in ("q8", "bf16"):
        be = BatchedEngine(cfg, params, tok, n_slots=4, max_seq=4096,
                           kv_cache_dtype=cache if cache == "q8" else torch.bfloat16,
                           device=dev)
        be.warmup()
        rng = np.random.default_rng(6)
        times = []
        for _ in range(2):  # the first: warm-up
            before = kernels.device_counts()
            slots = [be.add_request([int(t) for t in rng.integers(3, cfg.n_vocab, n)],
                                    LOOP_STEPS, SamplerConfig(temp=0.0))
                     for n in LOOP_SERVE_LENS]
            m0 = dict(be.metrics)
            while not all(s.stop_reason is not None for s in slots):
                be.step()
            for s in slots:
                be.release(s)
            steps = be.metrics["n_decode_steps"] - m0["n_decode_steps"]
            times.append(((be.metrics["t_decode_device_s"] - m0["t_decode_device_s"]) / steps,
                          (be.metrics["t_decode_s"] - m0["t_decode_s"]) / steps))
        ran = {k: v - before[k] for k, v in kernels.device_counts().items() if v != before[k]}
        emit("batched_step", f"8b {cache} 4 slots", times[-1][0] * 1e3,
             wall_ms=times[-1][1] * 1e3, decode_steps=steps,
             decode_stream_launches=ran.get("decode_stream", 0))
        del be
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()


def nib4_times(torch, dev, flush, emit) -> None:
    """K8-nib4 on RQMM_NIB4_CASES (gpt-oss's gate experts, inputs from seeds
    11 and 12), where the checkout has it (K5-nib4 is in ``QMM_CASES``)."""
    import numpy as np

    from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as qmm

    if not hasattr(qmm, "rqmm_nib4"):
        emit("rqmm_nib4", "gpt-oss", None, left_out="no nib4 mode in this checkout")
        return
    qt = oss_experts(dev)
    g = torch.Generator(device=dev).manual_seed(11)
    rng = np.random.default_rng(12)
    for case, P in RQMM_NIB4_CASES:
        idx = torch.tensor(oss_pair_ids(rng, P), dtype=torch.int32, device=dev)
        x = torch.randn((P, OSS_D), generator=g, device=dev).to(torch.bfloat16)
        emit("rqmm_nib4", case, device_ms(lambda: qmm.rqmm_nib4(x, qt, idx), torch, flush))


def k5_times(torch, dev, flush, emit, sweep: bool) -> None:
    """K5 on ``QMM_CASES`` (inputs from seed 80 + the case's index): ``ms``
    the call the main path makes (``quant_matmul`` on bf16 x: this
    checkout's K5 and whatever it launches beside it), ``kernel_ms`` the
    wrapper's own (f32 out) and the launch counts of one main-path call;
    with ``sweep`` (``--splits``), a checkout with ``qmm_config`` also
    every split count at 64- and 128-row tiles, by the launcher."""
    from llama_cpp_gfx906_tpu_torch import kernels
    from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as qmm

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for i, spec in enumerate(QMM_CASES):
        c = qmm_case(torch, dev, spec, 80 + i)
        before = kernels.counts()
        c["kern"]()
        counted = {k: n - before[k] for k, n in kernels.counts().items() if n != before[k]}
        extra = {}
        if hasattr(qmm, "qmm_config"):
            kp, Np = c["qt"].q.shape
            extra["bm"], extra["splits"] = qmm.qmm_config(spec[5], kp, Np, sms,
                                                          c["mode"] == "nib4",
                                                          c["qt"].m is not None)
        emit(c["name"], c["case"], device_ms(c["kern"], torch, flush),
             kernel_ms=device_ms(c["wrapper"], torch, flush), counted=counted, **extra)
        if sweep and "splits" in extra:
            steps = -(-c["qt"].q.shape[0] // qmm.QMM_STEP)
            for bm in (64, 128):
                for s in range(1, min(qmm.QMM_MAX_SPLITS, steps) + 1):
                    emit(c["name"], c["case"], device_ms(
                        lambda: qmm._qmm_launch(c["x"], c["qt"], c["mode"], torch.bfloat16, s,
                                                bm), torch, flush), splits=s, bm=bm)
        del c
        torch.cuda.empty_cache()


def k3_times(torch, dev, flush, emit) -> None:
    """K3 on ``K3_CASES`` (inputs from seed 17 + the case's index), each
    case whose mode the checkout's K3 has."""
    from llama_cpp_gfx906_tpu_torch.ops import flash_decode as fd
    from llama_cpp_gfx906_tpu_torch.ops.flash_decode import flash_decode

    for i, spec in enumerate(K3_CASES):
        if spec[0] and spec[0] not in flash_decode.modes:
            emit("flash_decode", spec[1], None, left_out="no such mode in this checkout")
            continue
        c = k3_case(torch, dev, spec, 17 + i)
        args = (c["q"], c["k"], c["v"], c["npast"], c["scale"])
        extra = {}
        if hasattr(fd, "split_count"):  # the split count of a checkout with one
            extra["splits"] = fd.split_count(c["q"], c["k"], c["kw"].get("shared_k"))
        emit("flash_decode", c["case"],
             device_ms(lambda: flash_decode(*args, **c["kw"]), torch, flush), mode=c["mode"],
             **extra)
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
