"""Device times of the split-K kernels of a checkout, at the main paths' shapes.

The cases live here, and ``chip_smoke.py`` builds its kernel cases from the
same lists: K1 / K2 (``GEMV_CASES``: the 8B head, ``attn_v`` and Q4_K
projections), K8 (``EXPERT_CASES``: Mixtral's experts at 2 and 8 pairs)
and K6 / K7 in each mode (``DECODE_CASES``: a few full-width layers of
each model, or a small model's whole stack).  Each is timed as
``chip_smoke.py`` times a kernel (:func:`device_ms`).  Synthetic weights
from seed 0; caches of random rows filled to n_past 3000.  With
``--splits``, K1 / K2 are also timed at every split count the kernel
takes (``gemv_splits`` picks one of them).

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
import json
import subprocess
import sys
import tempfile
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
    """A GEMV_CASES weight: rows from ``rng``, packed with folded scales."""
    from llama_cpp_gfx906_tpu_torch.gguf.constants import GGMLType
    from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as qmm
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import q4k_rows, q6k_rows

    t = GGMLType[gtype]
    rows = (q6k_rows if t == GGMLType.Q6_K else q4k_rows)(rng, N, K)
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout whose package to time")
    ap.add_argument("--label", default="")
    ap.add_argument("--splits", action="store_true",
                    help="also time K1 / K2 at every split count")
    args = ap.parse_args(argv)
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
    kernels.build_all(("gemv", "decode_stream", "rqmm"))
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)

    def emit(kernel, case, ms, **extra):
        print(json.dumps(dict(label=args.label, kernel=kernel, case=case, ms=ms, **extra)),
              flush=True)

    for name, case, gtype, K, N, pad in GEMV_CASES:
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
    for case, gtype, N, K, pairs in EXPERT_CASES:
        qt = expert_weights(gtype, N, K, dev)
        for P in pairs:
            idx = torch.tensor(pair_ids(prng, P), dtype=torch.int32, device=dev)
            x = torch.randn((P, K), generator=g, device=dev).to(torch.bfloat16)
            emit("rqmm_int8", f"{case} P={P}", device_ms(lambda: qmm.rqmm_int8(x, qt, idx),
                                                         torch, flush))
        del qt
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        for name, preset, L, batches, synth in DECODE_CASES:
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


if __name__ == "__main__":
    main()
