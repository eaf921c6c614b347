#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``llama_cpp_gfx906_tpu_torch``) on one card.

Phases, each printing JSON lines:
  0. the card (nvidia-smi name and power limit) and the kernel build, with
     what ``-Xptxas -v`` reports per kernel;
  1. each kernel against its plain PyTorch version at the shapes of the 8B
     Q4_K_M main path, with its time, its bound and a PyTorch yardstick;
  2. the 8B Q4_K_M model end to end (synthetic weights from a seed, full
     width): ``Engine.from_gguf`` then a greedy ``generate``, with every
     kernel's launch count read around it;
  3. the committed tinydoc fixture at f32 on the card: pinned greedy tokens
     and held-out perplexity.
The last line is ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero.  Without a CUDA device, or without the package beside this
file, it exits non-zero and prints no result.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOP_S = 989e12       # H100 SXM dense bf16 tensor-core peak
TOL = 2e-2                 # max |kernel - plain| / max |plain|, as the JAX tests
FIX = ROOT / "tests" / "fixtures"

KERNEL_INFO = {
    "gemv_int8": ("llama_cpp_gfx906_tpu_torch/csrc/gemv.cu",
                  "llama_cpp_gfx906_tpu/ops/quant_matmul.py:725"),
    "gemv_nib4c": ("llama_cpp_gfx906_tpu_torch/csrc/gemv.cu",
                   "llama_cpp_gfx906_tpu/ops/quant_matmul.py:813"),
    "flash_decode": ("llama_cpp_gfx906_tpu_torch/csrc/flash_decode.cu",
                     "llama_cpp_gfx906_tpu/ops/flash_decode.py:62"),
    "flash_attention": ("llama_cpp_gfx906_tpu_torch/csrc/flash_attention.cu",
                        "llama_cpp_gfx906_tpu/ops/flash_attention.py:29"),
}


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def device_ms(fn, torch, flush, n: int = 10) -> float:
    """Device time per call of ``fn``, without the host's launch overhead:
    n calls, each after an L2 flush (the decode path finds its weights
    cold), are captured in a CUDA graph and replayed; a graph of the n
    flushes alone is timed the same way and subtracted.  Median of 3
    replays, by CUDA events."""
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
    del graphs
    return (times[0] - times[1]) / n


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_S * 1e3, flops / BF16_FLOP_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def check(name: str, got, ref, torch) -> tuple[float, float]:
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    abs_err = float((got - ref).abs().max())
    rel = abs_err / max(float(ref.abs().max()), 1e-30)
    if rel > TOL:
        raise AssertionError(f"{name}: max error / max|plain| = {rel} > {TOL}")
    return abs_err, rel


def phase_build(torch):
    from llama_cpp_gfx906_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.build_all()
    report = {}
    for name in kernels.SOURCES:
        lines = kernels.ptxas_reports.get(name, "").splitlines()
        report[name] = [ln.split("ptxas info    :")[-1].strip() for ln in lines
                        if "registers" in ln or "spill" in ln or "Compiling" in ln]
        kernels.lib(name)
    emit(phase="build", seconds=time.perf_counter() - t0, ptxas=report)


def phase_kernels(torch, results: dict) -> None:
    import torch.nn.functional as F

    from llama_cpp_gfx906_tpu_torch.gguf.constants import GGMLType
    from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as qmm
    from llama_cpp_gfx906_tpu_torch.ops.attention import attend
    from llama_cpp_gfx906_tpu_torch.ops.flash_attention import flash_attention
    from llama_cpp_gfx906_tpu_torch.ops.flash_decode import flash_decode
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import q4k_rows, q6k_rows
    import numpy as np

    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)

    def record(name, case, err, ms, plain_ms, nbytes, flops, lib_ms):
        b_ms, b_by = bound(nbytes, flops)
        emit(phase="kernel", kernel=name, case=case, max_abs_err=err[0],
             rel_err=err[1], tol=TOL, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
             bound_by=b_by, library_ms=lib_ms)
        results.setdefault(name, []).append(dict(
            case=case, max_abs_err=err[0], ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))

    # K1 / K2: folded Q6_K int8 (head, attn_v) and folded Q4_K nib4c
    gemvs = [("gemv_int8", "lm_head 4096x129024", GGMLType.Q6_K, 4096, 128256, True),
             ("gemv_int8", "attn_v 4096x1024", GGMLType.Q6_K, 4096, 1024, False),
             ("gemv_nib4c", "attn_qk 4096x5120", GGMLType.Q4_K, 4096, 5120, False),
             ("gemv_nib4c", "attn_output 4096x4096", GGMLType.Q4_K, 4096, 4096, False),
             ("gemv_nib4c", "ffn_gate_up 4096x28672", GGMLType.Q4_K, 4096, 28672, False),
             ("gemv_nib4c", "ffn_down 14336x4096", GGMLType.Q4_K, 14336, 4096, False)]
    for name, case, gtype, K, N, pad in gemvs:
        rows = (q6k_rows if gtype == GGMLType.Q6_K else q4k_rows)(rng, N, K)
        qt = qmm.pack_gguf_tensor(rows.reshape(-1), gtype, (N, K),
                                  fold_scales=True, device=dev)
        if pad:
            qt = qmm.pad_qt_n(qt)
        x = torch.randn((1, K), generator=g, device=dev).to(torch.bfloat16)
        kern = getattr(qmm, name)
        got = kern(x, qt)
        ref = qmm.gemv_plain(x, qt)
        err = check(f"{name} {case}", got, ref, torch)
        w = qmm.dequantize_qt(qt, torch.bfloat16)
        nbytes = sum(t.numel() * t.element_size()
                     for t in (qt.q, qt.s, qt.m, qt.sd, qt.md, x) if t is not None)
        nbytes += N * 4
        record(name, case, err, device_ms(lambda: kern(x, qt), torch, flush),
               device_ms(lambda: qmm.gemv_plain(x, qt), torch, flush),
               nbytes, 2 * K * N,
               device_ms(lambda: torch.matmul(x, w), torch, flush))
        del w, qt

    # K3: decode attention over an 8192-row bf16 cache, GQA 32/8, D = 128
    B, Hq, Hkv, D, S = 1, 32, 8, 128, 8192
    kc = torch.randn((B, S, Hkv, D), generator=g, device=dev).to(torch.bfloat16)
    vc = torch.randn((B, S, Hkv, D), generator=g, device=dev).to(torch.bfloat16)
    sinks = torch.randn((Hq,), generator=g, device=dev)
    scale = D ** -0.5
    for n_past in (17, 3000, 8000):
        for window, sk in ((0, None), (1024, sinks)):
            q = torch.randn((B, 1, Hq, D), generator=g, device=dev).to(torch.bfloat16)
            npast = torch.tensor([n_past], dtype=torch.int32, device=dev)
            args = (q, kc, vc, npast, scale, window, 0.0, sk)
            case = f"n_past={n_past} window={window} sinks={sk is not None}"
            err = check(f"flash_decode {case}", flash_decode(*args), attend(*args), torch)
            live = min(n_past + 1, window) if window else n_past + 1
            kl = kc[:, :n_past + 1].transpose(1, 2).contiguous()
            vl = vc[:, :n_past + 1].transpose(1, 2).contiguous()
            qs = q.transpose(1, 2)
            lib_ms = (device_ms(lambda: F.scaled_dot_product_attention(
                qs, kl, vl, scale=scale, enable_gqa=True), torch, flush)
                if not window and sk is None else None)
            record("flash_decode", case, err,
                   device_ms(lambda: flash_decode(*args), torch, flush),
                   device_ms(lambda: attend(*args), torch, flush),
                   2 * live * Hkv * D * 2 + 2 * Hq * D * 2,
                   4 * Hq * live * D, lib_ms)

    # K4: prefill of 512 tokens at n_past 0 and 256
    T = 512
    for n_past in (0, 256):
        q = torch.randn((B, T, Hq, D), generator=g, device=dev).to(torch.bfloat16)
        npast = torch.tensor([n_past], dtype=torch.int32, device=dev)
        args = (q, kc, vc, npast, scale, 0, 0.0, None)
        case = f"T={T} n_past={n_past}"
        err = check(f"flash_attention {case}", flash_attention(*args),
                    attend(*args), torch)
        n_keys = n_past + T
        pairs = T * n_past + T * (T + 1) // 2  # causal (query, key) pairs
        kl = kc[:, :n_keys].transpose(1, 2).contiguous()
        vl = vc[:, :n_keys].transpose(1, 2).contiguous()
        qs = q.transpose(1, 2).contiguous()
        mask = (torch.arange(n_keys, device=dev)[None, :]
                <= n_past + torch.arange(T, device=dev)[:, None])
        record("flash_attention", case, err,
               device_ms(lambda: flash_attention(*args), torch, flush),
               device_ms(lambda: attend(*args), torch, flush),
               2 * (2 * T * Hq * D) + 2 * n_keys * Hkv * D * 2,
               4 * Hq * pairs * D,
               device_ms(lambda: F.scaled_dot_product_attention(
                   qs, kl, vl, attn_mask=mask, scale=scale, enable_gqa=True),
                   torch, flush))
    del kc, vc, flush
    torch.cuda.empty_cache()


def counters():
    from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as qmm
    from llama_cpp_gfx906_tpu_torch.ops.flash_attention import flash_attention
    from llama_cpp_gfx906_tpu_torch.ops.flash_decode import flash_decode

    return {"gemv_int8": qmm.gemv_int8, "gemv_nib4c": qmm.gemv_nib4c,
            "flash_decode": flash_decode, "flash_attention": flash_attention}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in counters().items()}


def phase_8b(torch, launches: dict) -> None:
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "synth-8b-q4km.gguf")
        t0 = time.perf_counter()
        write_synth(path, "8b", seed=0)
        t_write = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        eng = Engine.from_gguf(path, max_seq=8192)
    mem_weights = torch.cuda.memory_allocated()
    words = " ".join(f"w{i % 97}" for i in range(110))
    prompt = f"The synthetic eight billion model reads: {words}"
    n_prompt = len(eng.tokenizer.tokenize(prompt))
    reset_counts()
    _, toks = eng.generate(prompt, n_predict=32, stop_on_eog=False)
    torch.cuda.synchronize()
    launches.update(read_counts())
    logits = eng.decode_one(toks[-1])
    perf = eng.perf.summary()
    profile = profile_decode(torch, eng, toks[-1])
    emit(phase="8b", synth_write_s=t_write, prompt_tokens=n_prompt,
         new_tokens=len(toks), **perf,
         prefill_s=eng.perf.t_prefill_s, decode_s=eng.perf.t_decode_s,
         weights_and_cache_bytes=mem_weights,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches)
    emit(phase="8b_decode_profile", **profile)
    if len(toks) != 32 or not all(0 <= t < eng.cfg.n_vocab for t in toks):
        raise AssertionError(f"8b: bad generated tokens {toks}")
    if logits.shape != (eng.cfg.n_vocab,) or not bool(
            torch.isfinite(torch.from_numpy(logits)).all()):
        raise AssertionError("8b: logits of the wrong shape or not finite")
    idle = [k for k, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"8b: kernels never launched on the main path: {idle}")
    del eng
    torch.cuda.empty_cache()


def profile_decode(torch, eng, tok: int, steps: int = 4) -> dict:
    """Device time of a few decode steps by kernel name (torch.profiler),
    against the wall time of the same steps run without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.decode_one(tok)
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.decode_one(tok)
    by_name = {}
    for ev in prof.key_averages():
        # device-side events only (kernels, memsets, copies): the CPU-side
        # aten:: ops also carry the device time of the kernels they launch
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3 / steps
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return dict(steps=steps, wall_ms_per_token=wall_ms,
                device_ms_per_token=device_ms if by_name else "not measured",
                device_idle_share=(1 - device_ms / wall_ms) if by_name else "not measured",
                top_kernels_ms_per_token=[[k[:90], v] for k, v in top])


def phase_tinydoc(torch) -> None:
    import numpy as np

    from llama_cpp_gfx906_tpu_torch.models.llama import KVCache, forward
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine

    expected = json.loads((FIX / "tinydoc_expected.json").read_text())
    eng = Engine.from_gguf(str(FIX / "tinydoc-byte.f16.gguf"), max_seq=192,
                           dtype=torch.float32)
    reset_counts()
    for prompt, want in expected["greedy"].items():
        _, toks = eng.generate(prompt, n_predict=len(want), stop_on_eog=False)
        if toks != want:
            raise AssertionError(f"tinydoc: greedy drift for {prompt!r}: {toks}")
    held = expected["held_ids"]
    kv = KVCache.create(eng.cfg, 1, len(held) - 1, torch.float32, eng.device)
    with torch.inference_mode():
        logits, _ = forward(eng.params, eng.cfg,
                            torch.tensor([held[:-1]], device=eng.device), kv)
        logp = torch.log_softmax(logits[0], -1)[
            torch.arange(len(held) - 1, device=eng.device),
            torch.tensor(held[1:], device=eng.device)]
    ppl = float(np.exp(-float(logp.mean())))
    counts = read_counts()
    emit(phase="tinydoc", greedy_prompts=len(expected["greedy"]), ppl=ppl,
         ppl_pinned=expected["ppl"], launches=counts)
    if abs(ppl - expected["ppl"]) / expected["ppl"] >= 0.01:
        raise AssertionError(f"tinydoc: ppl {ppl} vs pinned {expected['ppl']}")
    if not (counts["flash_decode"] and counts["flash_attention"]):
        raise AssertionError(f"tinydoc: attention kernels not launched: {counts}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    if not (ROOT / "llama_cpp_gfx906_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit(phase="card", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device_count=torch.cuda.device_count())
    phase_build(torch)
    results: dict = {}
    launches: dict = {}
    phase_kernels(torch, results)
    phase_8b(torch, launches)
    phase_tinydoc(torch)

    # one main-path shape per kernel in the summary line
    pick = {"gemv_int8": "lm_head", "gemv_nib4c": "ffn_gate_up",
            "flash_decode": "n_past=8000 window=0", "flash_attention": "n_past=256"}
    summary = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = next(r for r in results[name] if pick[name] in r["case"])
        summary.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(x["max_abs_err"] for x in results[name]),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
