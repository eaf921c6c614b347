#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``llama_cpp_gfx906_tpu_torch``) on one card.

Phases, each printing JSON lines:
  0. the card (nvidia-smi name and power limit) and the kernel build, with
     what ``-Xptxas -v`` reports per kernel;
  1. each kernel against its plain PyTorch version at the shapes of the main
     paths, with its time, its bound and a PyTorch yardstick: K1-K4 at the
     8B Q4_K_M shapes, K5 at the 270M Q8_0 prefill shapes, K6 on two
     full-width 8B layers (B 1 and 8), K7 on the 18 layers of the 270M Q8_0
     shape;
  2. the 8B Q4_K_M model end to end (synthetic weights from a seed, full
     width and depth): ``Engine.from_gguf``, a greedy ``generate`` (decode
     through K6), the per-layer loop called as a function (K1-K4), and a
     profile of both decode routes;
  3. ``8b_fused``: the same model through ``decode_fused`` (one captured
     step replayed per token), launches per token, and 8 steps of the K6
     path held against the per-layer loop from the same state;
  4. ``270m_q8_0``: the 270M-shape Q8_0 model (prefill through K5, decode
     through K7), the same way;
  5. the committed tinydoc fixture at f32 on the card: pinned greedy tokens
     and held-out perplexity.
Kernel launch counts are set to 0 before each path and read after it.  A
replayed CUDA graph bypasses the wrappers' counts, so the fused loop's
launches per token are read from a profiler trace of its replays.  The
last line is ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero.  Without a CUDA device, or without the package beside this file,
it exits non-zero and prints no result.

Usage: python3 chip_smoke.py

``python3 chip_smoke.py --plant-faults`` shows instead whether the K6/K7
check can fail: it copies the package and this script into temporary
directories, plants one known fault (``FAULTS``) in each copy's
``csrc/decode_stream.cu``, builds the copies, and prints the errors that
``decode_errors`` reads for each (K6 on two 8B layers, K7 on the 18 layers
of the 270M shape; B = 1, n_past 700), the unmodified source first.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOP_S = 989e12       # H100 SXM dense bf16 tensor-core peak
F32_FLOP_S = 67e12         # H100 SXM float32 outside the tensor cores
TOL = 2e-2                 # max |kernel - plain| / max |plain|, as the JAX tests
TOL_Q4KM = 8e-2            # decode logits of the Q4_K_M mix (JAX tests' bound)
FIX = ROOT / "tests" / "fixtures"
PKG = "llama_cpp_gfx906_tpu_torch"

# --plant-faults: name -> (text of csrc/decode_stream.cu, what replaces it)
FAULTS = {
    "none": None,
    # the current token's value left out of its own attention output
    "no_self_value": ("o += ws * bf16r(ldcg(vrow + d));", ""),
    # every layer but the last loses its MLP residual
    "no_mlp_residual": (
        "return bf16r(ldcg(a.xmid + (size_t)m * D + k) +\n"
        "                   bf16r(ldcg(a.dn_acc + (size_t)m * D + k)));",
        "return bf16r(ldcg(a.xmid + (size_t)m * D + k));"),
    # attention reads one live row too few
    "one_row_short": ("const int live = min(np, a.S);",
                      "const int live = min(np - 1, a.S);"),
}

KERNEL_INFO = {
    "gemv_int8": ("llama_cpp_gfx906_tpu_torch/csrc/gemv.cu",
                  "llama_cpp_gfx906_tpu/ops/quant_matmul.py:725"),
    "gemv_nib4c": ("llama_cpp_gfx906_tpu_torch/csrc/gemv.cu",
                   "llama_cpp_gfx906_tpu/ops/quant_matmul.py:813"),
    "flash_decode": ("llama_cpp_gfx906_tpu_torch/csrc/flash_decode.cu",
                     "llama_cpp_gfx906_tpu/ops/flash_decode.py:62"),
    "flash_attention": ("llama_cpp_gfx906_tpu_torch/csrc/flash_attention.cu",
                        "llama_cpp_gfx906_tpu/ops/flash_attention.py:29"),
    "decode_stream": ("llama_cpp_gfx906_tpu_torch/csrc/decode_stream.cu",
                      "llama_cpp_gfx906_tpu/ops/decode_stream.py:97"),
    "decode_step": ("llama_cpp_gfx906_tpu_torch/csrc/decode_stream.cu",
                    "llama_cpp_gfx906_tpu/ops/decode_step.py:69"),
    "qmm_int8": ("llama_cpp_gfx906_tpu_torch/csrc/qmm.cu",
                 "llama_cpp_gfx906_tpu/ops/quant_matmul.py:706"),
}
# the path whose launch count each kernel reports in the summary line
KERNEL_PATH = {"gemv_int8": "8b_layer_loop", "gemv_nib4c": "8b_layer_loop",
               "flash_decode": "8b_layer_loop", "flash_attention": "8b_layer_loop",
               "decode_stream": "8b", "decode_step": "270m_q8_0",
               "qmm_int8": "270m_q8_0"}


FAILURES: list[str] = []


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def fail(message: str) -> None:
    """Record a failed check; the script goes on with the other phases and
    exits non-zero at the end."""
    FAILURES.append(message)
    emit(phase="failure", message=message)


def run_phase(name: str, fn, *args):
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 (every phase runs; the exit code tells)
        traceback.print_exc()
        fail(f"{name}: {e!r}")
        return None


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


def bound(nbytes: float, flops: float, flop_s: float = BF16_FLOP_S) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_S * 1e3, flops / flop_s * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def check(name: str, got, ref, torch, tol: float = TOL) -> tuple[float, float]:
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite kernel output")
    abs_err = float((got - ref).abs().max())
    rel = abs_err / max(float(ref.abs().max()), 1e-30)
    if not rel <= tol:
        fail(f"{name}: max error / max|plain| = {rel} > {tol}")
    return abs_err, rel


def kernel_counts(reset: bool = False) -> dict:
    """Every kernel wrapper's launch count (set to 0 first with ``reset``)."""
    from llama_cpp_gfx906_tpu_torch import kernels
    from llama_cpp_gfx906_tpu_torch.models import llama  # noqa: F401 (registers all)

    if reset:
        kernels.set_counts({})
    return kernels.counts()


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


def phase_kernels(torch, results: dict, tmp: Path) -> None:
    import torch.nn.functional as F

    from llama_cpp_gfx906_tpu_torch.gguf.constants import GGMLType
    from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as qmm
    from llama_cpp_gfx906_tpu_torch.ops.attention import attend
    from llama_cpp_gfx906_tpu_torch.ops.flash_attention import flash_attention
    from llama_cpp_gfx906_tpu_torch.ops.flash_decode import flash_decode
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import q4k_rows, q6k_rows, q8_0_rows
    import numpy as np

    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)

    def record(name, case, err, ms, plain_ms, nbytes, flops, lib_ms,
               flop_s=BF16_FLOP_S, **extra):
        b_ms, b_by = bound(nbytes, flops, flop_s)
        emit(phase="kernel", kernel=name, case=case, max_abs_err=err[0],
             rel_err=err[1], tol=TOL, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
             bound_by=b_by, library_ms=lib_ms, **extra)
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
    del kc, vc
    torch.cuda.empty_cache()

    # K5: the 270M Q8_0 prefill projections at the smoke prompt's 676 rows
    M = 676
    for case, K, N in (("attn_qkv 640x1536", 640, 1536),
                       ("attn_output 1024x640", 1024, 640),
                       ("ffn_gate_up 640x4096", 640, 4096),
                       ("ffn_down 2048x640", 2048, 640)):
        qt = qmm.pack_gguf_tensor(q8_0_rows(rng, N, K).reshape(-1), GGMLType.Q8_0,
                                  (N, K), device=dev)
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        err = check(f"qmm_int8 {case}", qmm.qmm_int8(x, qt), qmm.qmm_plain(x, qt), torch)
        w = qmm.dequantize_qt(qt, torch.bfloat16)
        record("qmm_int8", f"M={M} {case}", err,
               device_ms(lambda: qmm.qmm_int8(x, qt), torch, flush),
               device_ms(lambda: qmm.qmm_plain(x, qt), torch, flush),
               M * K * 2 + K * N + (K // qt.group) * N * 4 + M * N * 4,
               2 * M * K * N, device_ms(lambda: torch.matmul(x, w), torch, flush))
        del w, qt

    # K6 on two full-width 8B Q4_K_M layers, K7 on the 18 layers of the
    # 270M Q8_0 shape: the whole decode step against its plain version, the
    # per-layer loop's device time for the same step beside it
    from llama_cpp_gfx906_tpu_torch.ops import decode_step as k7
    from llama_cpp_gfx906_tpu_torch.ops import decode_stream as k6
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

    # K7's whole 18-layer stack is reported, not held to TOL: at that depth
    # these random weights carry one bf16 rounding that the kernel and the
    # plain version take differently to a few percent of the output (each
    # case reports ``one_ulp_spread``, the plain version's own such move)
    for name, preset, L, batches, whole in (("decode_stream", "8b", 2, (1, 8), True),
                                            ("decode_step", "270m-q8_0", None, (1,), False)):
        path = write_synth(str(tmp / f"{preset}-kernel.gguf"), preset, seed=0,
                           n_layers=L, n_vocab=512)
        eng = Engine.from_gguf(path, max_seq=4096)
        kern, plain = ((k6.fused_decode_step_streamed, k6.fused_decode_step_streamed_plain)
                       if name == "decode_stream"
                       else (k7.fused_decode_step, k7.fused_decode_step_plain))
        for B in batches:
            for n_past in (700, 3000):
                decode_case(torch, eng, name, kern, plain, B, n_past, g, flush,
                            record, whole)
        del eng
        torch.cuda.empty_cache()
    del flush


def decode_errors(torch, eng, kern, plain, B: int, n_past: int, toks) -> tuple:
    """A decode kernel against its plain version from one state: x for the
    tokens ``toks`` (B, 1) and caches of random rows (seed 11) filled to
    n_past.  Errors are max |kernel - plain| / max |plain|: of the whole
    stack's output x and its new K/V rows (``x``, ``k_rows``, ``v_rows``),
    of the first two layers as a stack of their own (``first_two_layers``,
    the hand-off between layers), and the worst of each layer run alone, as
    a one-layer stack on the same planes, fed the kernel's own output of
    the layer before (``per_layer``); depth amplifies neither of the two
    last.  ``one_ulp_spread`` is
    the plain version's own output moved by one bf16 ulp on one element of
    x: how far depth carries a single rounding.  Returns the errors, x and
    the three caches."""
    import dataclasses

    from llama_cpp_gfx906_tpu_torch.models.llama import KVCache
    from llama_cpp_gfx906_tpu_torch.runtime.weights import ParamDict

    params, cfg, dev = eng.params, eng.cfg, eng.device
    caches = []
    for _ in range(3):
        kv = KVCache.create(cfg, B, eng.max_seq, torch.bfloat16, dev)
        gg = torch.Generator(device=dev).manual_seed(11)
        kv.k.copy_(torch.randn(kv.k.shape, generator=gg, device=dev))
        kv.v.copy_(torch.randn(kv.v.shape, generator=gg, device=dev))
        kv.n_past.fill_(n_past)
        caches.append(kv)

    def rel(a, b) -> float:
        a, b = a.float(), b.float()
        return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))

    def rows(kv):
        return kv.k[:, :, n_past], kv.v[:, :, n_past]

    def sub_stack(first: int, n: int):
        """Layers [first, first + n) as a stack of their own, with their KV."""
        sub = ParamDict({"layers": torch.nn.ModuleList(list(params["layers"])[first:first + n])})
        kvs = [KVCache(k=c.k[first:first + n], v=c.v[first:first + n], n_past=c.n_past)
               for c in caches[:2]]
        return sub, dataclasses.replace(cfg, n_layers=n), kvs

    def stack_err(sub, sub_cfg, kvs, xin):
        a, b = kern(sub, sub_cfg, xin, kvs[0]), plain(sub, sub_cfg, xin, kvs[1])
        (ka, va), (kb, vb) = rows(kvs[0]), rows(kvs[1])
        return max(rel(a, b), rel(ka, kb), rel(va, vb)), a

    x = params["tok_emb"][toks]
    with torch.inference_mode():
        got = kern(params, cfg, x, caches[0])
        ref = plain(params, cfg, x, caches[1])
        (ka, va), (kb, vb) = rows(caches[0]), rows(caches[1])
        errs = dict(x=rel(got, ref), x_abs=float((got.float() - ref.float()).abs().max()),
                    k_rows=rel(ka, kb), v_rows=rel(va, vb), finite=bool(
                        torch.isfinite(got).all()))
        errs["first_two_layers"] = stack_err(*sub_stack(0, min(2, cfg.n_layers)), x)[0]
        worst, xl = 0.0, x
        for li in range(cfg.n_layers):
            err, xl = stack_err(*sub_stack(li, 1), xl)
            worst = max(worst, err)
        errs["per_layer"] = worst
        x1 = x.clone()
        x1[0, 0, 0] = (x1[0, 0, 0].float() * (1 + 2 ** -7)).to(x.dtype)
        errs["one_ulp_spread"] = rel(plain(params, cfg, x1, caches[2]), ref)
    torch.cuda.synchronize()
    return errs, x, caches


def decode_case(torch, eng, name, kern, plain, B, n_past, g, flush, record,
                whole_stack: bool) -> None:
    """One decode kernel case: its errors against the plain version (the
    first two layers and each layer alone always held to TOL; the whole
    stack too where ``whole_stack``), its time, the plain version's and
    the per-layer loop's, and the bound."""
    from llama_cpp_gfx906_tpu_torch.models.llama import KVCache, layers_forward
    from llama_cpp_gfx906_tpu_torch.ops import decode_step as k7
    from llama_cpp_gfx906_tpu_torch.ops import decode_stream as k6
    from llama_cpp_gfx906_tpu_torch.ops.quant_matmul import QuantTensor

    params, cfg = eng.params, eng.cfg
    gate = k6._stream_ok if name == "decode_stream" else k7._fused_ok
    if not gate(params, cfg, KVCache.create(cfg, B, eng.max_seq, torch.bfloat16, "meta"),
                B, 1):
        raise AssertionError(f"{name}: the gate refuses B={B}")
    toks = torch.randint(0, cfg.n_vocab, (B, 1), generator=g, device=eng.device)
    errs, x, caches = decode_errors(torch, eng, kern, plain, B, n_past, toks)
    case = f"L={cfg.n_layers} B={B} n_past={n_past}"
    if not errs["finite"]:
        fail(f"{name} {case}: non-finite kernel output")
    for what in ("first_two_layers", "per_layer") + (
            ("x", "k_rows", "v_rows") if whole_stack else ()):
        if not errs[what] <= TOL:
            fail(f"{name} {case} {what}: max error / max|plain| = {errs[what]} > {TOL}")
    with torch.inference_mode():
        ms = device_ms(lambda: kern(params, cfg, x, caches[0]), torch, flush)
        plain_ms = device_ms(lambda: plain(params, cfg, x, caches[1]), torch, flush)
        loop_ms = device_ms(lambda: layers_forward(params, cfg, x, caches[2]), torch, flush)
    planes = [t for p in params["layers"] for q in p.children()
              if isinstance(q, QuantTensor)
              for t in (q.q, q.s, q.m, q.sd, q.md) if t is not None]
    planes += [p[n] for p in params["layers"] for n in ("attn_norm", "ffn_norm")]
    HD = cfg.n_kv_heads * cfg.head_dim
    L, D = cfg.n_layers, cfg.n_embd
    macs = sum(q.K * q.N for p in params["layers"] for q in p.children()
               if isinstance(q, QuantTensor))
    nbytes = (sum(t.numel() * t.element_size() for t in planes)
              + 2 * L * B * (n_past + 1) * HD * 2  # live KV read, new rows written
              + B * D * 4)                         # x in and out (bf16)
    flops = 2 * B * macs + 4 * L * B * cfg.n_heads * (n_past + 1) * cfg.head_dim
    record(name, case, (errs["x_abs"], errs["x"]), ms, plain_ms, nbytes, flops, None,
           flop_s=F32_FLOP_S, per_layer_loop_ms=loop_ms,
           errors={k: v for k, v in errs.items() if k not in ("x_abs", "finite")},
           whole_stack_checked=whole_stack)
    del caches


def loop_logits(torch, eng, tok: int, layers_fn=None):
    """One decode step through ``layers_fn``, by default the per-layer loop
    (``layers_forward``, the route the JAX package takes off its
    accelerator: K1/K2 GEMVs and K3 attention per layer), called as a
    function, then the head."""
    from llama_cpp_gfx906_tpu_torch.models.llama import layers_forward
    from llama_cpp_gfx906_tpu_torch.ops.norms import rms_norm
    from llama_cpp_gfx906_tpu_torch.ops.quant_matmul import linear

    p, cfg = eng.params, eng.cfg
    with torch.inference_mode():
        x = p["tok_emb"][torch.tensor([[tok]], device=eng.device)]
        x = (layers_fn or layers_forward)(p, cfg, x, eng.kv)
        logits = linear(rms_norm(x, p["out_norm"], cfg.rms_eps), p["lm_head"]).float()
        eng.set_n_past(eng.n_past + 1)
        return logits[0, -1].cpu().numpy()


def profile_steps(torch, step, steps: int, tokens_per_step: int = 1) -> dict:
    """Device time of ``steps`` calls of ``step`` by kernel name
    (torch.profiler), against the wall time of the same calls run without
    the profiler, and the launches of the port's kernels that the trace
    recorded (graph replays included); per generated token."""
    from torch.profiler import ProfilerActivity, profile

    from llama_cpp_gfx906_tpu_torch import kernels

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    n_tok = steps * tokens_per_step
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_tok
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
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
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3 / n_tok
    dev_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    traced = kernels.traced_launches(prof)
    return dict(tokens=n_tok, wall_ms_per_token=wall_ms,
                traced_launches=traced,
                launches_per_token={k: n / n_tok for k, n in traced.items()},
                device_ms_per_token=dev_ms if by_name else "not measured",
                device_idle_share=(1 - dev_ms / wall_ms) if by_name else "not measured",
                top_kernels_ms_per_token=[[k[:90], v] for k, v in top])


def prompt_ids(eng) -> list[int]:
    words = " ".join(f"w{i % 97}" for i in range(110))
    return eng.tokenizer.tokenize(f"The synthetic model reads: {words}",
                                  add_special=True, parse_special=True)


def compare_routes(torch, eng, ids, tol: float, enforce_loop: bool,
                   steps: int = 8) -> dict:
    """``steps`` decode steps from the same state three ways, each fed the
    fused route's greedy tokens and read through the same head: the fused
    route (``forward``: one K6/K7 launch), the decode kernel's plain version
    (``decode_layers_plain``, the same rounding points) and the per-layer
    loop.  The kernel is held to its plain version (max |diff| / max |plain|
    <= TOL); the fused route to the loop by the JAX kernel tests' check,
    assert_allclose(rtol=tol, atol=tol), where ``enforce_loop``.  For the
    18-layer 270M Q8_0 it is reported, not enforced: the JAX package's own
    K7 sits beyond 2e-2 of its loop there (the fused route's f32 carry and
    bf16-rounded int8 weights against the loop's roundings, amplified by
    depth; tests/test_torch_decode_step.py::
    test_k7_loop_gap_matches_jax_reference holds the port to that gap)."""
    import numpy as np

    from llama_cpp_gfx906_tpu_torch.ops.decode_stream import decode_layers_plain

    eng.reset()
    tok = int(np.argmax(eng.prefill(ids)))
    n0 = eng.n_past
    k0, v0 = eng.kv.k.clone(), eng.kv.v.clone()

    def rewind():
        eng.kv.k.copy_(k0)
        eng.kv.v.copy_(v0)
        eng.set_n_past(n0)

    fused, fed = [], []
    for _ in range(steps):
        fed.append(tok)
        fused.append(eng.decode_one(tok))
        tok = int(np.argmax(fused[-1]))
    rewind()
    plain = [loop_logits(torch, eng, t, decode_layers_plain) for t in fed]
    rewind()
    loop = [loop_logits(torch, eng, t) for t in fed]
    del k0, v0

    def stats(xs, ys):
        return dict(
            max_rel=max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(xs, ys)),
            allclose_ratio=max(float((np.abs(a - b) / (tol + tol * np.abs(b))).max())
                               for a, b in zip(xs, ys)),
            greedy_agree=sum(int(np.argmax(a) == np.argmax(b)) for a, b in zip(xs, ys)))

    out = dict(steps=steps, tol=tol, kernel_vs_plain=stats(fused, plain),
               fused_vs_loop=stats(fused, loop), plain_vs_loop=stats(plain, loop))
    if not all(np.isfinite(a).all() for a in fused):
        fail("fused route: non-finite logits")
    if not out["kernel_vs_plain"]["max_rel"] <= TOL:
        fail(f"fused route vs its plain version: {out['kernel_vs_plain']}, tol {TOL}")
    if enforce_loop and not out["fused_vs_loop"]["allclose_ratio"] <= 1:
        fail(f"fused route vs per-layer loop: {out['fused_vs_loop']}, tol {tol}")
    return out


def fused_run(torch, eng, ids, kernel: str, chunk: int = 32, chunks: int = 2) -> dict:
    """decode_fused after a prefill: tok/s (the first chunk, which captures
    the step, apart), and a profile of two chunks with the launches per
    token that its trace recorded."""
    import numpy as np

    eng.reset()
    tok = int(np.argmax(eng.prefill(ids)))
    t0 = time.perf_counter()
    toks = eng.decode_fused(tok, n_steps=chunk)
    capture_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(chunks):
        toks = eng.decode_fused(toks[-1], n_steps=chunk)
    dt = time.perf_counter() - t0
    prof = profile_steps(torch, lambda: eng.decode_fused(tok, n_steps=chunk), 2,
                         tokens_per_step=chunk)
    per_tok = prof["launches_per_token"]
    want = {kernel: 1.0, "gemv_int8": 1.0, "gemv_nib4c": 0.0, "flash_decode": 0.0}
    if any(per_tok[k] != v for k, v in want.items()):
        fail(f"fused decode launches per token {per_tok}, want {want}")
    return dict(first_chunk_with_capture_s=capture_s,
                decode_fused_tok_s=chunk * chunks / dt,
                launches=prof["traced_launches"], launches_per_token=per_tok,
                profile=prof)


def phase_8b(torch, paths: dict, tmp: Path):
    from llama_cpp_gfx906_tpu_torch.models.llama import decode_route
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

    path = str(tmp / "synth-8b-q4km.gguf")
    t0 = time.perf_counter()
    write_synth(path, "8b", seed=0)
    t_write = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    eng = Engine.from_gguf(path, max_seq=8192)
    mem_weights = torch.cuda.memory_allocated()
    route = decode_route(eng.params, eng.cfg, eng.kv)
    if route != "k6":
        raise AssertionError(f"8b: decode route {route}, want k6")
    ids = prompt_ids(eng)
    prompt = eng.tokenizer.detokenize(ids)
    kernel_counts(reset=True)
    _, toks = eng.generate(prompt, n_predict=32, stop_on_eog=False)
    torch.cuda.synchronize()
    paths["8b"] = launches = kernel_counts()
    logits = eng.decode_one(toks[-1])
    perf = eng.perf.summary()
    emit(phase="8b", synth_write_s=t_write, prompt_tokens=len(ids),
         new_tokens=len(toks), route=route, **perf,
         prefill_s=eng.perf.t_prefill_s, decode_s=eng.perf.t_decode_s,
         weights_and_cache_bytes=mem_weights,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches)
    if len(toks) != 32 or not all(0 <= t < eng.cfg.n_vocab for t in toks):
        raise AssertionError(f"8b: bad generated tokens {toks}")
    if logits.shape != (eng.cfg.n_vocab,) or not bool(
            torch.isfinite(torch.from_numpy(logits)).all()):
        raise AssertionError("8b: logits of the wrong shape or not finite")
    if launches["decode_stream"] != 32 or launches["gemv_nib4c"] or launches["flash_decode"]:
        raise AssertionError(f"8b: decode went elsewhere than K6: {launches}")
    if launches["qmm_int8"]:  # nib4c and folded int8: the dequant matmul, as in JAX
        raise AssertionError(f"8b: prefill went through K5: {launches}")

    # the per-layer loop (PR 1's decode route), called as a function
    eng.reset()
    kernel_counts(reset=True)
    tok = int(eng.prefill(ids).argmax())
    t0 = time.perf_counter()
    for _ in range(16):
        tok = int(loop_logits(torch, eng, tok).argmax())
    loop_tok_s = 16 / (time.perf_counter() - t0)
    torch.cuda.synchronize()
    paths["8b_layer_loop"] = kernel_counts()
    emit(phase="8b_layer_loop", decode_tok_s=loop_tok_s, launches=paths["8b_layer_loop"])
    profile = {
        "k6_decode_one": profile_steps(torch, lambda: eng.decode_one(tok), 4),
        "per_layer_loop": profile_steps(torch, lambda: loop_logits(torch, eng, tok), 4)}
    emit(phase="8b_decode_profile", **profile)
    return eng, ids


def phase_8b_fused(torch, eng, ids, paths: dict) -> None:
    out = fused_run(torch, eng, ids, "decode_stream")
    paths["8b_fused"] = out["launches"]
    cmp = compare_routes(torch, eng, ids, TOL_Q4KM, enforce_loop=True)
    eng.reset()
    eng.prefill(ids)
    t0 = time.perf_counter()
    for i in range(16):
        eng.decode_one(5 + i)
    one_tok_s = 16 / (time.perf_counter() - t0)
    prompt = eng.tokenizer.detokenize(ids)
    t_dec, n_dec = eng.perf.t_decode_s, eng.perf.n_decode
    t0 = time.perf_counter()
    _, toks = eng.generate_fused(prompt, n_predict=65, stop_on_eog=False, chunk=32)
    gen_s = time.perf_counter() - t0
    emit(phase="8b_fused", decode_one_tok_s=one_tok_s,
         generate_fused_s=gen_s, generate_fused_new_tokens=len(toks),
         generate_fused_decode_tok_s=(eng.perf.n_decode - n_dec)
         / (eng.perf.t_decode_s - t_dec),
         **out, layer_loop_comparison=cmp)


def phase_270m(torch, paths: dict, tmp: Path) -> None:
    from llama_cpp_gfx906_tpu_torch.models.llama import decode_route
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

    path = str(tmp / "synth-270m-q8_0.gguf")
    t0 = time.perf_counter()
    write_synth(path, "270m-q8_0", seed=0)
    t_write = time.perf_counter() - t0
    eng = Engine.from_gguf(path, max_seq=4096)
    route = decode_route(eng.params, eng.cfg, eng.kv)
    if route != "k7":
        raise AssertionError(f"270m_q8_0: decode route {route}, want k7")
    ids = prompt_ids(eng)
    kernel_counts(reset=True)
    _, toks = eng.generate(eng.tokenizer.detokenize(ids), n_predict=32, stop_on_eog=False)
    torch.cuda.synchronize()
    paths["270m_q8_0"] = launches = kernel_counts()
    if launches["decode_step"] != 32 or launches["gemv_nib4c"] or launches["flash_decode"]:
        raise AssertionError(f"270m_q8_0: decode went elsewhere than K7: {launches}")
    if launches["qmm_int8"] != 4 * eng.cfg.n_layers:  # one prefill, 4 projections
        raise AssertionError(f"270m_q8_0: prefill went elsewhere than K5: {launches}")
    perf = eng.perf.summary()
    out = fused_run(torch, eng, ids, "decode_step")
    cmp = compare_routes(torch, eng, ids, TOL, enforce_loop=False)
    emit(phase="270m_q8_0", synth_write_s=t_write, prompt_tokens=len(ids),
         route=route, generate_launches=launches, **perf, **out,
         layer_loop_comparison=cmp)
    del eng
    torch.cuda.empty_cache()


def phase_tinydoc(torch, paths: dict) -> None:
    import numpy as np

    from llama_cpp_gfx906_tpu_torch.models.llama import KVCache, forward
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine

    expected = json.loads((FIX / "tinydoc_expected.json").read_text())
    eng = Engine.from_gguf(str(FIX / "tinydoc-byte.f16.gguf"), max_seq=192,
                           dtype=torch.float32)
    kernel_counts(reset=True)
    for prompt, want in expected["greedy"].items():
        _, toks = eng.generate(prompt, n_predict=len(want), stop_on_eog=False)
        if toks != want:
            raise AssertionError(f"tinydoc: greedy drift for {prompt!r}: {toks}")
        if eng.generate_fused(prompt, n_predict=len(want), stop_on_eog=False,
                              chunk=8)[1] != want:
            raise AssertionError(f"tinydoc: generate_fused drift for {prompt!r}")
    held = expected["held_ids"]
    kv = KVCache.create(eng.cfg, 1, len(held) - 1, torch.float32, eng.device)
    with torch.inference_mode():
        logits, _ = forward(eng.params, eng.cfg,
                            torch.tensor([held[:-1]], device=eng.device), kv)
        logp = torch.log_softmax(logits[0], -1)[
            torch.arange(len(held) - 1, device=eng.device),
            torch.tensor(held[1:], device=eng.device)]
    ppl = float(np.exp(-float(logp.mean())))
    paths["tinydoc"] = counts = kernel_counts()
    emit(phase="tinydoc", greedy_prompts=len(expected["greedy"]), ppl=ppl,
         ppl_pinned=expected["ppl"], launches=counts)
    if abs(ppl - expected["ppl"]) / expected["ppl"] >= 0.01:
        raise AssertionError(f"tinydoc: ppl {ppl} vs pinned {expected['ppl']}")
    if not (counts["flash_decode"] and counts["flash_attention"]):
        raise AssertionError(f"tinydoc: attention kernels not launched: {counts}")


def plant_faults() -> None:
    """``--plant-faults`` (see the module docstring)."""
    with tempfile.TemporaryDirectory() as tmp:
        roots = {}
        for fault, edit in FAULTS.items():
            root = Path(tmp) / fault
            shutil.copytree(ROOT / PKG, root / PKG,
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "chip_smoke.py", root)
            if edit is not None:
                src = root / PKG / "csrc" / "decode_stream.cu"
                text = src.read_text()
                if text.count(edit[0]) != 1:
                    raise RuntimeError(f"{fault}: the text to replace is not in "
                                       "decode_stream.cu once")
                src.write_text(text.replace(edit[0], edit[1]))
            roots[fault] = root
        build = f"from {PKG} import kernels; kernels.build_all(('decode_stream',))"
        procs = [subprocess.Popen([sys.executable, "-c", build], cwd=root)
                 for root in roots.values()]
        if any(p.wait() != 0 for p in procs):
            raise RuntimeError("a copy failed to build")
        for fault, root in roots.items():
            subprocess.run([sys.executable, "chip_smoke.py", "--decode-errors", fault],
                           cwd=root, check=True)


def decode_errors_of_copy(torch, fault: str) -> None:
    """The K6 and K7 errors of this copy's kernels, one JSON line each."""
    from llama_cpp_gfx906_tpu_torch.ops import decode_step as k7
    from llama_cpp_gfx906_tpu_torch.ops import decode_stream as k6
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

    with tempfile.TemporaryDirectory() as tmp:
        for name, preset, L, kern in (
                ("decode_stream", "8b", 2, k6.fused_decode_step_streamed),
                ("decode_step", "270m-q8_0", None, k7.fused_decode_step)):
            eng = Engine.from_gguf(write_synth(f"{tmp}/{preset}.gguf", preset, seed=0,
                                               n_layers=L, n_vocab=512), max_seq=4096)
            toks = torch.tensor([[7]], device=eng.device)
            errs, _, _ = decode_errors(torch, eng, kern, k6.decode_layers_plain, 1,
                                       700, toks)
            emit(phase="planted_fault", fault=fault, kernel=name,
                 layers=eng.cfg.n_layers, rel_err=errs, tol=TOL)
            del eng
            torch.cuda.empty_cache()


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
    if sys.argv[1:2] == ["--plant-faults"]:
        plant_faults()
        return
    if sys.argv[1:2] == ["--decode-errors"]:
        decode_errors_of_copy(torch, sys.argv[2])
        return

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit(phase="card", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device_count=torch.cuda.device_count())
    phase_build(torch)
    results: dict = {}
    paths: dict = {}
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        run_phase("kernel", phase_kernels, torch, results, tmp)
        got = run_phase("8b", phase_8b, torch, paths, tmp)
        if got is not None:
            run_phase("8b_fused", phase_8b_fused, torch, *got, paths)
        del got
        torch.cuda.empty_cache()
        run_phase("270m_q8_0", phase_270m, torch, paths, tmp)
    run_phase("tinydoc", phase_tinydoc, torch, paths)

    idle = [k for k, p in KERNEL_PATH.items() if not paths.get(p, {}).get(k)]
    if idle:
        fail(f"kernels never launched on their path: {idle}")
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} failed check(s)", file=sys.stderr)
        sys.exit(1)
    # one main-path shape per kernel in the summary line
    pick = {"gemv_int8": "lm_head", "gemv_nib4c": "ffn_gate_up",
            "flash_decode": "n_past=8000 window=0", "flash_attention": "n_past=256",
            "decode_stream": "B=1 n_past=3000", "decode_step": "B=1 n_past=3000",
            "qmm_int8": "ffn_gate_up"}
    summary = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = next(r for r in results[name] if pick[name] in r["case"])
        summary.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=paths[KERNEL_PATH[name]][name],
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
