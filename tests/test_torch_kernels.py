"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here carries the ``cuda`` marker and skips without a CUDA device
(decided in a fixture, so every pytest worker collects the same tests).  The
file imports neither jax nor the JAX package, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tolerance: max |kernel - plain| / max |plain| < 2e-2, as the JAX kernel
tests use (bf16 inputs; the kernels accumulate in f32).
"""

import json
import os

import numpy as np
import pytest
import torch

from llama_cpp_gfx906_tpu_torch import kernels
from llama_cpp_gfx906_tpu_torch.gguf.constants import GGMLType
from llama_cpp_gfx906_tpu_torch.gguf.quants import quantize
from llama_cpp_gfx906_tpu_torch.ops import attention as tatt
from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as tq
from llama_cpp_gfx906_tpu_torch.models import llama as tllama
from llama_cpp_gfx906_tpu_torch.models.config import ModelConfig
from llama_cpp_gfx906_tpu_torch.ops import decode_step as k7
from llama_cpp_gfx906_tpu_torch.ops import decode_stream as k6
from llama_cpp_gfx906_tpu_torch.ops.flash_attention import flash_attention
from llama_cpp_gfx906_tpu_torch.ops.flash_decode import flash_decode
from llama_cpp_gfx906_tpu_torch.runtime.weights import ParamDict, fuse_projections
from llama_cpp_gfx906_tpu_torch.tools import kernel_times as kt
from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import q4k_rows, q6k_rows, write_synth

pytestmark = pytest.mark.cuda
FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
TOL = 2e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(got, ref):
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())


def _raw(qtype, N, K, seed):
    rng = np.random.default_rng(seed)
    if qtype == GGMLType.Q4_K:
        return q4k_rows(rng, N, K).reshape(-1)
    if qtype == GGMLType.Q6_K:
        return q6k_rows(rng, N, K).reshape(-1)
    return quantize((rng.standard_normal((N, K)) / np.sqrt(K)).astype(np.float32), qtype)


@pytest.mark.parametrize("M", [1, 3, 8])
@pytest.mark.parametrize("qtype,fold,K,N", [
    (GGMLType.Q6_K, True, 4096, 1024), (GGMLType.Q6_K, False, 1024, 512),
    (GGMLType.Q8_0, False, 1536, 208), (GGMLType.Q4_K, True, 2048, 384),
    (GGMLType.Q4_K, False, 14336, 128), (GGMLType.Q4_0, False, 512, 96)])
def test_gemv_kernel_matches_plain(cuda_device, qtype, fold, K, N, M):
    qt = tq.pack_gguf_tensor(_raw(qtype, N, K, 7), qtype, (N, K),
                             fold_scales=fold, device=cuda_device)
    x = torch.randn((M, K), device=cuda_device).to(torch.bfloat16)
    kern = tq.gemv_nib4c if qt.fmt == "nib4c" else tq.gemv_int8
    before = kern.launches
    got = kern(x, qt)
    ref = tq.gemv_plain(x, qt)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert got.shape == (M, N) and _rel(got, ref) < TOL


def test_gemv_kernel_padded_head(cuda_device):
    """A pad_qt_n head: the kernel covers the pad, the wrapper slices it."""
    qt = tq.pad_qt_n(tq.pack_gguf_tensor(_raw(GGMLType.Q6_K, 9000, 512, 8),
                                         GGMLType.Q6_K, (9000, 512),
                                         fold_scales=True, device=cuda_device))
    assert qt.q.shape[-1] == 10240
    x = torch.randn((1, 512), device=cuda_device).to(torch.bfloat16)
    got = tq.linear(x, qt)
    assert got.shape == (1, 9000) and got.dtype == torch.bfloat16
    assert _rel(got, tq.gemv_plain(x, qt)) < TOL


@pytest.mark.parametrize("qtype,K,N,M", [
    (GGMLType.Q8_0, 640, 1536, 676), (GGMLType.Q8_0, 2048, 640, 9),
    (GGMLType.Q6_K, 1024, 512, 100), (GGMLType.Q4_0, 800, 256, 65)])
def test_qmm_kernel_matches_plain(cuda_device, qtype, K, N, M):
    """K5 through ``linear`` (M > 8 on the card), plain scales with and
    without mins (a Q4_0 weight whose K has no nib4c chunk stays int8)."""
    qt = tq.pack_gguf_tensor(_raw(qtype, N, K, 9), qtype, (N, K), device=cuda_device)
    assert tq.qmm_tileable(qt) and (qt.m is not None) == (qtype == GGMLType.Q4_0)
    x = torch.randn((1, M, K), device=cuda_device).to(torch.bfloat16)
    before = tq.qmm_int8.launches
    got = tq.linear(x, qt)
    ref = tq.qmm_plain(x[0], qt)
    torch.cuda.synchronize()
    assert tq.qmm_int8.launches == before + 1
    assert got.shape == (1, M, N) and _rel(got[0], ref) < TOL


def _attn_case(seed, B, T, Hq, Hkv, D, S, n_past, dev, dtype):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, T, Hq, D), generator=g) * 0.3
    k = torch.randn((B, S, Hkv, D), generator=g) * 0.3
    v = torch.randn((B, S, Hkv, D), generator=g) * 0.3
    sinks = torch.randn((Hq,), generator=g)
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            torch.tensor(n_past, dtype=torch.int32, device=dev), sinks.to(dev))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("kind,T,n_past,window,use_sinks,softcap", [
    ("decode", 1, (17, 200), 0, False, 0.0), ("decode", 4, (0, 250), 64, True, 0.0),
    ("decode", 1, (3, 300), 0, False, 30.0),
    ("prefill", 130, (0, 90), 0, False, 0.0), ("prefill", 70, (5, 100), 48, True, 0.0),
    ("prefill", 64, (0, 1), 0, False, 20.0)])
def test_attention_kernels_match_plain(cuda_device, dtype, D, kind, T, n_past,
                                       window, use_sinks, softcap):
    q, k, v, npast, sinks = _attn_case(6, 2, T, 8, 2, D, 384, n_past, cuda_device, dtype)
    args = (q, k, v, npast, D ** -0.5, window, softcap, sinks if use_sinks else None)
    kern = flash_decode if kind == "decode" else flash_attention
    before = kern.launches
    got = kern(*args)
    ref = tatt.attend(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert got.shape == q.shape and got.dtype == q.dtype and _rel(got, ref) < TOL


@pytest.mark.parametrize("kind,dtype", [("decode", torch.bfloat16),
                                        ("prefill", torch.bfloat16),
                                        ("prefill", torch.float32)])
def test_attention_kernels_head_dim_256(cuda_device, kind, dtype):
    """Head dim 256 (the Gemma-3 shapes): K3 with a bf16 cache, K4 with
    either; K3 refuses an f32 cache at this width."""
    T = 1 if kind == "decode" else 70
    q, k, v, npast, sinks = _attn_case(6, 2, T, 4, 1, 256, 384, (17, 300),
                                       cuda_device, dtype)
    args = (q, k, v, npast, 256 ** -0.5, 0, 0.0, None)
    kern = flash_decode if kind == "decode" else flash_attention
    got = kern(*args)
    assert _rel(got, tatt.attend(*args)) < TOL
    if kind == "decode":
        q, k, v, npast, _ = _attn_case(6, 2, T, 4, 1, 256, 384, (17, 300),
                                       cuda_device, torch.float32)
        with pytest.raises(ValueError, match="head dim"):
            flash_decode(q, k, v, npast, 256 ** -0.5)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("Hq,Hkv", [(28, 4), (32, 4)])
@pytest.mark.parametrize("T,n_past", [(1, (700, 3000)), (16, (256, 0)), (44, (256, 0)),
                                      (101, (0, 17)), (256, (0, 9))])
def test_attention_kernels_at_qwen_group_sizes(cuda_device, kv, Hq, Hkv, T, n_past):
    """K3 and K4 at the Qwen group sizes, Dh 128: Qwen2.5-7B's 28/4 (G 7)
    and Qwen3-30B-A3B's 32/4 (G 8), bf16 and int8 caches, decode at
    n_past 700 / 3000 and the ragged prefill chunks (a 300-token prompt's
    256 then its 44-token tail; 101 tokens); K3 takes G·T <= 128 as the
    dispatch does, K4 the rest."""
    from llama_cpp_gfx906_tpu_torch.ops.flash_attention import flash_attention_plain
    from llama_cpp_gfx906_tpu_torch.ops.flash_decode import flash_decode_plain
    from llama_cpp_gfx906_tpu_torch.ops.kv_quant import quantize_rows

    q, k, v, npast, _ = _attn_case(23, len(n_past), T, Hq, Hkv, 128, 3072, n_past,
                                   cuda_device, torch.bfloat16)
    decode = (Hq // Hkv) * T <= 128
    kw = {}
    if kv == "int8":
        k, v = quantize_rows(k), quantize_rows(v)
        if not decode:
            kw = dict(k_scales=k.s[..., 0], v_scales=v.s[..., 0])
            k, v = k.q, v.q
    args = (q, k, v, npast, 128 ** -0.5)
    kern, plain = ((flash_decode, flash_decode_plain) if decode
                   else (flash_attention, flash_attention_plain))
    before = kern.launches
    got = kern(*args, **kw)
    ref = plain(*args, **kw)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert got.shape == q.shape and torch.isfinite(got.float()).all()
    assert _rel(got, ref) < TOL


def test_mha_dispatch_on_card(cuda_device):
    """G*T <= 128 takes K3, more takes K4; the cache is updated in place."""
    for T, kern in ((2, flash_decode), (80, flash_attention)):
        q, k, v, npast, _ = _attn_case(9, 1, T, 4, 2, 64, 256, (30,), cuda_device,
                                       torch.bfloat16)
        k_new, v_new = k[:, :T].clone(), v[:, :T].clone()
        before = kern.launches
        out, kc, _ = tatt.mha_with_cache(q, k_new, v_new, k, v, npast, 0.125)
        assert kern.launches == before + 1 and kc is k
        assert torch.equal(k[:, 30:30 + T], k_new)
        assert _rel(out, tatt.attend(q, k, v, npast, 0.125)) < TOL


def test_engine_card_matches_cpu(cuda_device, tmp_path):
    """The slice as a whole: the tiny synthetic Q4_K_M model at f32 through
    the kernels on the card and through the plain versions on the CPU."""
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine

    path = write_synth(str(tmp_path / "tiny.gguf"), "tiny", seed=1)
    engines = [Engine.from_gguf(path, max_seq=128, dtype=torch.float32, device=d)
               for d in (cuda_device, "cpu")]
    ids = engines[0].tokenizer.tokenize("card against cpu", add_special=True)
    logits = [[e.prefill(ids)] for e in engines]
    for tok in (5, 77, 300):
        for e, out in zip(engines, logits):
            out.append(e.decode_one(tok))
    for a, b in zip(*logits):
        assert np.abs(a - b).max() / np.abs(b).max() < 1e-3


def test_tinydoc_pinned_on_card(cuda_device):
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine

    with open(os.path.join(FIX, "tinydoc_expected.json")) as f:
        expected = json.load(f)
    eng = Engine.from_gguf(os.path.join(FIX, "tinydoc-byte.f16.gguf"), max_seq=192,
                           dtype=torch.float32)
    for prompt, want in expected["greedy"].items():
        assert eng.generate(prompt, n_predict=len(want), stop_on_eog=False)[1] == want


def _decode_model(mix, dev, L=2, D=512, Hq=4, Hkv=1, Dh=128, F=1024, V=256, fold=True):
    """Per-layer params of a small llama in one weight mix: "q8_0" (fused
    q|k|v, int8 plain scales: K7's) or "q4_k_m" (split-v nib4c + int8)."""
    cfg = ModelConfig(arch="llama", n_layers=L, n_embd=D, n_heads=Hq, n_kv_heads=Hkv,
                      head_dim=Dh, n_ff=F, n_vocab=V, n_ctx_train=4096)
    kinds = ({"wq": GGMLType.Q8_0, "wv": GGMLType.Q8_0} if mix == "q8_0"
             else {"wq": GGMLType.Q4_K, "wv": GGMLType.Q6_K})
    shapes = {"wq": (Hq * Dh, D), "wk": (Hkv * Dh, D), "wv": (Hkv * Dh, D),
              "wo": (D, Hq * Dh), "w_gate": (F, D), "w_up": (F, D), "w_down": (D, F)}
    layers = []
    for li in range(L):
        p = {"attn_norm": torch.rand(D, device=dev) + 0.5,
             "ffn_norm": torch.rand(D, device=dev) + 0.5}
        for j, (name, (N, K)) in enumerate(shapes.items()):
            qtype = kinds.get(name, kinds["wq"])
            p[name] = tq.pack_gguf_tensor(_raw(qtype, N, K, 100 * li + j), qtype, (N, K),
                                          fold_scales=fold, device=dev)
        layers.append(ParamDict(fuse_projections(p)))
    params = ParamDict({"tok_emb": (torch.randn((V, D), device=dev) * 0.5).to(torch.bfloat16),
                        "out_norm": torch.ones(D, device=dev),
                        "lm_head": tq.pack_gguf_tensor(_raw(GGMLType.Q8_0, V, D, 9),
                                                       GGMLType.Q8_0, (V, D), device=dev)})
    params["layers"] = torch.nn.ModuleList(layers)
    return cfg, params


def _filled_cache(cfg, B, S, n_past, dev, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(3)
    kv = tllama.KVCache.create(cfg, B, S, dtype, dev)
    kv.k.copy_(torch.randn(kv.k.shape, generator=g, device=dev))
    kv.v.copy_(torch.randn(kv.v.shape, generator=g, device=dev))
    kv.n_past.copy_(torch.tensor(n_past, dtype=torch.int32))
    return kv


@pytest.mark.parametrize("mix,fold,n_past,dtype", [
    ("q8_0", False, (37,), torch.bfloat16),
    ("q4_k_m", True, (300,), torch.bfloat16),
    ("q4_k_m", False, (5, 300, 0), torch.bfloat16),
    ("q4_k_m", True, (130, 17, 250, 511, 64, 1, 99, 400), torch.float32)])
def test_decode_kernels_match_plain(cuda_device, mix, fold, n_past, dtype):
    """K6 (and K7 where its gate admits the model) against the plain
    version: the hidden state and every cache row, from the same state."""
    cfg, params = _decode_model(mix, cuda_device, fold=fold)
    B, S = len(n_past), 512
    x = params["tok_emb"][torch.arange(B, device=cuda_device)[:, None] * 7]
    kerns = [k6.fused_decode_step_streamed]
    kv0 = _filled_cache(cfg, B, S, n_past, cuda_device, dtype)
    assert k6._stream_ok(params, cfg, kv0, B, 1)
    if k7._fused_ok(params, cfg, kv0, B, 1):
        kerns.append(k7.fused_decode_step)
    for kern in kerns:
        kv, ref_kv = (_filled_cache(cfg, B, S, n_past, cuda_device, dtype) for _ in range(2))
        before = kern.launches
        got = kern(params, cfg, x, kv)
        ref = k6.fused_decode_step_streamed_plain(params, cfg, x, ref_kv)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        assert got.shape == x.shape and got.dtype == x.dtype and _rel(got, ref) < TOL
        assert _rel(kv.k, ref_kv.k) < TOL and _rel(kv.v, ref_kv.v) < TOL


def test_decode_kernel_replays_in_a_graph(cuda_device):
    """A captured K6 step replays with the same result as eager launches
    (the barrier and the accumulators return to rest after each launch)."""
    cfg, params = _decode_model("q4_k_m", cuda_device)
    x = params["tok_emb"][torch.tensor([[3]], device=cuda_device)]
    kv = _filled_cache(cfg, 1, 512, (100,), cuda_device)
    want = k6.fused_decode_step_streamed(params, cfg, x, kv).clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = k6.fused_decode_step_streamed(params, cfg, x, kv)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert _rel(out, want) < 1e-5


def _greedy_consistent(eng, prompt, got, want, tol):
    """``got`` equals the greedy tokens ``want``, or first departs from them
    where the two tokens' logits are within ``tol`` of the largest logit
    (the kernels' atomic sums may order a near-tie either way)."""
    if got == want:
        return True
    j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    ids = eng.tokenizer.tokenize(prompt, add_special=True, parse_special=True)
    eng.reset()
    logits = eng.prefill(ids)
    for t in want[:j]:
        logits = eng.decode_one(t)
    return abs(logits[got[j]] - logits[want[j]]) <= tol * np.abs(logits).max()


def _decode_logits(eng, tok, layers_fn):
    """One decode step of ``eng`` through ``layers_fn`` and the head."""
    from llama_cpp_gfx906_tpu_torch.ops.norms import rms_norm

    p, cfg = eng.params, eng.cfg
    with torch.inference_mode():
        x = layers_fn(p, cfg, tllama.embed(p, cfg, torch.tensor([[tok]], device=eng.device)),
                      eng.kv)
        logits = tq.linear(rms_norm(x, p["out_norm"], cfg.rms_eps), p["lm_head"])
    eng.set_n_past(eng.n_past + 1)
    return logits.float()[0, -1].cpu().numpy()


@pytest.mark.parametrize("preset,route,tol", [("tiny-q8_0", "k7", 2e-2),
                                              ("small", "k6", 8e-2)])
def test_engine_fused_route_matches_cpu(cuda_device, tmp_path, monkeypatch, preset,
                                        route, tol):
    """The slice as a whole: a synthetic model decodes through its decode
    kernel on the card (the small Q4_K_M one by K6, its layers declared
    large) and through the kernel's plain version on the CPU, from the same
    state, within 2e-2 (max |diff| / max |cpu|); against the per-layer loop
    on the CPU it stays within the JAX kernel tests' check
    (``assert_allclose`` with rtol = atol = 8e-2) for the Q4_K_M mix.  (The
    Q8_0 kernel rounds each weight to bf16, as the JAX kernel does, and the
    loop does not; the gap grows with depth, so chip_smoke.py reports it.)
    decode_fused
    gives the card's own greedy tokens, one launch of the decode kernel per
    token (graph replays bypass the wrappers' counts: launches are read
    from the kernels' device-side counts)."""
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine

    if route == "k6":
        monkeypatch.setattr(tllama, "FUSED_LAYER_BYTES", 0)
    path = write_synth(str(tmp_path / f"{preset}.gguf"), preset, seed=2)
    card, cpu = (Engine.from_gguf(path, max_seq=256, device=d) for d in (cuda_device, "cpu"))
    assert tllama.decode_route(card.params, card.cfg, card.kv) == route
    ids = card.tokenizer.tokenize("card against cpu", add_special=True)
    card.prefill(ids)
    cpu.prefill(ids)
    n0 = cpu.n_past
    k0, v0 = cpu.kv.k.clone(), cpu.kv.v.clone()
    kern = k7.fused_decode_step if route == "k7" else k6.fused_decode_step_streamed
    route_kernel = "decode_step" if route == "k7" else "decode_stream"
    before = kern.launches
    feed = (5, 77, 300, 12)
    a = [card.decode_one(tok) for tok in feed]
    b = [_decode_logits(cpu, tok, k6.decode_layers_plain) for tok in feed]
    assert kern.launches == before + 4
    for x, y in zip(a, b):
        assert np.abs(x - y).max() / np.abs(y).max() < TOL
    if route == "k6":
        cpu.kv.k.copy_(k0)
        cpu.kv.v.copy_(v0)
        cpu.set_n_past(n0)
        for x, tok in zip(a, feed):
            np.testing.assert_allclose(x, cpu.decode_one(tok), rtol=tol, atol=tol)
    toks = card.generate("card", n_predict=12, stop_on_eog=False)[1]
    fused = card.generate_fused("card", n_predict=11, stop_on_eog=False, chunk=5)[1]
    assert _greedy_consistent(card, "card", fused, toks[:11], tol)
    before = kernels.device_counts()
    for _ in range(2):  # two chunks of replays
        card.decode_fused(fused[-1], n_steps=5)
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in kernels.device_counts().items()}
    assert (ran[route_kernel], ran["gemv_int8"], ran["gemv_nib4c"],
            ran["flash_decode"]) == (10, 10, 0, 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("mode,T,n_past,window,use_sinks", [
    ("int8", 1, (17, 200), 0, False), ("int8", 4, (0, 250), 64, True),
    ("shared", 1, (3, 300), 0, False), ("shared", 3, (40, 0), 32, True),
    ("int8+shared", 1, (17, 290), 0, False), ("int8+shared", 2, (0, 64), 48, False)])
def test_k3_quant_and_shared_modes_match_plain(cuda_device, dtype, D, mode, T, n_past,
                                               window, use_sinks):
    """K3's int8-KV mode, shared-prefix mode and both together against the
    plain version (the einsum over f32-dequantized rows, the shared rows
    concatenated before the own ones)."""
    from llama_cpp_gfx906_tpu_torch.ops.flash_decode import flash_decode_plain
    from llama_cpp_gfx906_tpu_torch.ops.kv_quant import quantize_rows

    q, k, v, npast, sinks = _attn_case(11, 2, T, 8, 2, D, 320, n_past, cuda_device, dtype)
    kw = {}
    if "shared" in mode:
        g = torch.Generator().manual_seed(12)
        kw = {n: (torch.randn((1, 75, 2, D), generator=g) * 0.3).to(cuda_device, dtype)
              for n in ("shared_k", "shared_v")}
    if "int8" in mode:
        k, v = quantize_rows(k), quantize_rows(v)
    args = (q, k, v, npast, D ** -0.5, window, 0.0, sinks if use_sinks else None)
    name = mode.replace("+", "_")
    count = flash_decode.modes[name]
    before, before_mode = flash_decode.launches, count.launches
    on_device = kernels.device_counts()
    got = flash_decode(*args, **kw)
    ref = flash_decode_plain(*args, **kw)
    torch.cuda.synchronize()
    assert (flash_decode.launches, count.launches) == (before + 1, before_mode + 1)
    ran = {k: v - on_device[k] for k, v in kernels.device_counts().items()}
    assert (ran["flash_decode"], ran[f"flash_decode_{name}"]) == (1, 1)
    assert got.shape == q.shape and got.dtype == q.dtype and _rel(got, ref) < TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("T,n_past,window", [(130, (0, 90), 0), (64, (5, 100), 48)])
def test_k4_int8_mode_matches_plain(cuda_device, dtype, D, T, n_past, window):
    from llama_cpp_gfx906_tpu_torch.ops.flash_attention import flash_attention_plain
    from llama_cpp_gfx906_tpu_torch.ops.kv_quant import quantize_rows

    q, k, v, npast, _ = _attn_case(13, 2, T, 8, 2, D, 320, n_past, cuda_device, dtype)
    kq, vq = quantize_rows(k), quantize_rows(v)
    args = (q, kq.q, vq.q, npast, D ** -0.5, window, 0.0, None)
    kw = dict(k_scales=kq.s[..., 0], v_scales=vq.s[..., 0])
    mode = flash_attention.modes["int8_mma" if dtype == torch.bfloat16 else "int8"]
    before = mode.launches
    got = flash_attention(*args, **kw)
    ref = flash_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    assert mode.launches == before + 1
    assert got.shape == q.shape and got.dtype == q.dtype and _rel(got, ref) < TOL


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("variant", ["plain", "window", "softcap", "sinks"])
@pytest.mark.parametrize("T", [17, 130, 257])
def test_k4_tensor_core_body_matches_plain(cuda_device, kv, D, variant, T):
    """K4's tensor-core body (a bf16 q) on a bf16 or int8 cache at every
    head dim, ragged T at B 2 with differing n_past: within TOL of the plain
    version, the same bits over two launches, counted in its mode on the
    host and on the device."""
    from llama_cpp_gfx906_tpu_torch.ops.flash_attention import flash_attention_plain
    from llama_cpp_gfx906_tpu_torch.ops.kv_quant import quantize_rows

    q, k, v, npast, sinks = _attn_case(31, 2, T, 8, 2, D, 700, (5, 300), cuda_device,
                                       torch.bfloat16)
    kw = {}
    if kv == "int8":
        kq, vq = quantize_rows(k), quantize_rows(v)
        k, v, kw = kq.q, vq.q, dict(k_scales=kq.s[..., 0], v_scales=vq.s[..., 0])
    args = (q, k, v, npast, D ** -0.5, 48 if variant == "window" else 0,
            20.0 if variant == "softcap" else 0.0, sinks if variant == "sinks" else None)
    name = "int8_mma" if kv == "int8" else "mma"
    before, on_device = flash_attention.modes[name].launches, kernels.device_counts()
    got = flash_attention(*args, **kw)
    again = flash_attention(*args, **kw)
    ref = flash_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    assert flash_attention.modes[name].launches == before + 2
    ran = {c: n - on_device[c] for c, n in kernels.device_counts().items()}
    assert (ran["flash_attention"], ran[f"flash_attention_{name}"]) == (2, 2)
    assert torch.equal(got, again)
    assert got.shape == q.shape and got.dtype == q.dtype and _rel(got, ref) < TOL


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_k4_f32_q_takes_the_fma_body(cuda_device, kv):
    """An f32 q (f32 or int8 cache) runs K4's FMA body: no tensor-core
    launch, full f32 products."""
    from llama_cpp_gfx906_tpu_torch.ops.flash_attention import flash_attention_plain
    from llama_cpp_gfx906_tpu_torch.ops.kv_quant import quantize_rows

    q, k, v, npast, _ = _attn_case(32, 2, 130, 8, 2, 128, 700, (5, 300), cuda_device,
                                   torch.float32)
    kw = {}
    if kv == "int8":
        kq, vq = quantize_rows(k), quantize_rows(v)
        k, v, kw = kq.q, vq.q, dict(k_scales=kq.s[..., 0], v_scales=vq.s[..., 0])
    args = (q, k, v, npast, 128 ** -0.5)
    on_device = kernels.device_counts()
    got = flash_attention(*args, **kw)
    torch.cuda.synchronize()
    ran = {c: n - on_device[c] for c, n in kernels.device_counts().items()
           if c.startswith("flash_attention")}
    want = {c: 0 for c in ran}
    want["flash_attention"] = 1
    if kv == "int8":
        want["flash_attention_int8"] = 1
    assert ran == want
    assert got.dtype == torch.float32 and _rel(got, flash_attention_plain(*args, **kw)) < 1e-5


@pytest.mark.parametrize("index", range(len(kt.K4_CASES)))
def test_k4_at_model_shapes(cuda_device, index):
    """K4 on each ``kernel_times.K4_CASES`` entry (the model phases'
    prefill shapes, each mode) against its plain version, twice."""
    from llama_cpp_gfx906_tpu_torch.ops.flash_attention import flash_attention_plain

    c = kt.k4_case(torch, cuda_device, kt.K4_CASES[index], 60 + index)
    count = flash_attention.modes[c["mode"]] if c["mode"] else flash_attention
    before = count.launches
    got = flash_attention(*c["args"], **c["kw"])
    torch.cuda.synchronize()
    assert count.launches == before + 1
    assert _rel(got, flash_attention_plain(*c["args"], **c["kw"])) < TOL
    assert torch.equal(got, flash_attention(*c["args"], **c["kw"]))


def test_mha_q8_and_shared_dispatch_on_card(cuda_device):
    """A q8 cache: K3 for G*T <= 128, K4 beyond; a shared segment: K3, and
    the counted einsum beyond 128 queries per KV head."""
    from llama_cpp_gfx906_tpu_torch.ops.kv_quant import QuantKV, quantize_rows

    g = torch.Generator().manual_seed(3)
    sh = {n: (torch.randn((1, 20, 2, 64), generator=g) * 0.3).to(cuda_device)
          for n in ("shared_k", "shared_v")}
    for T, shared, kern in ((2, False, flash_decode), (80, False, flash_attention),
                            (2, True, flash_decode), (80, True, tatt.attend_einsum)):
        q, k, v, npast, _ = _attn_case(9, 1, T, 4, 2, 64, 256, (30,), cuda_device,
                                       torch.float32)
        kc, vc = QuantKV.zeros(k.shape, cuda_device), QuantKV.zeros(v.shape, cuda_device)
        before = kern.launches
        out, _, _ = tatt.mha_with_cache(q, k[:, :T], v[:, :T], kc, vc, npast, 0.125,
                                        **(sh if shared else {}))
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        assert torch.equal(kc.q[:, 30:30 + T], quantize_rows(k[:, :T]).q)
        ref = tatt.attend_einsum(q, kc, vc, npast, 0.125, **(sh if shared else {}))
        assert _rel(out, ref) < TOL


def _k3_modes_run(q, k, v, npast, scale, name, **kw):
    """K3 twice and its plain version once on the same inputs; the wrapper's
    and the device's counts of mode ``name`` each move by 2."""
    from llama_cpp_gfx906_tpu_torch.ops.flash_decode import flash_decode_plain

    count = flash_decode.modes[name]
    before, on_device = count.launches, kernels.device_counts()
    got = flash_decode(q, k, v, npast, scale, **kw)
    again = flash_decode(q, k, v, npast, scale, **kw)
    ref = flash_decode_plain(q, k, v, npast, scale, **kw)
    torch.cuda.synchronize()
    ran = {c: n - on_device[c] for c, n in kernels.device_counts().items()}
    assert count.launches == before + 2 and ran[f"flash_decode_{name}"] == 2
    assert torch.equal(got, again)
    assert got.shape == q.shape and torch.isfinite(got.float()).all()
    return _rel(got, ref)


def _ladder(n_past, S, T, group, dev):
    """Row i at logical i // group, the T new tokens continuing the ladder
    (tests/test_flash_decode.py ``_self_extend_pos``)."""
    n = torch.tensor(n_past)
    kv_pos = (torch.arange(S)[None, :] // group).expand(len(n_past), S)
    q_pos = (n[:, None] + torch.arange(T)[None, :]) // group
    return (kv_pos.to(dev, torch.int32).contiguous(), q_pos.to(dev, torch.int32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case,T,Hkv,S,extra", [
    ("alibi", 1, 2, 256, {}), ("alibi", 3, 4, 256, {}),
    ("alibi", 1, 2, 384, dict(logit_softcap=25.0, sliding_window=96)),
    ("int8_alibi", 1, 2, 256, {}), ("shared_alibi", 1, 2, 384, dict(sliding_window=160)),
    ("pos", 1, 2, 256, {}), ("pos", 4, 2, 384, dict(sliding_window=32)),
    ("int8_pos", 1, 2, 256, {}), ("alibi_pos", 1, 2, 256, {})])
def test_k3_alibi_and_pos_modes_match_plain(cuda_device, dtype, case, T, Hkv, S, extra):
    """K3's ALiBi and self-extend modes at the JAX kernel tests' shapes
    (tests/test_flash_decode.py:157-230: B 2, Hq 4, D 64; ALiBi with GQA,
    MHA at T 3, with softcap 25 and window 96, over an int8 cache, after 96
    shared rows with window 160; logical positions i // 2, i // 3 at T 4 with
    window 32, int8, with ALiBi) against the plain version, bit-identical
    over two launches, counted in their modes."""
    from llama_cpp_gfx906_tpu_torch.ops.attention import alibi_slopes_for
    from llama_cpp_gfx906_tpu_torch.ops.kv_quant import quantize_rows

    n_past = (37, S - T - 9)
    q, k, v, npast, _ = _attn_case(31, 2, T, 4, Hkv, 64, S, n_past, cuda_device, dtype)
    kw = dict(extra)
    if "alibi" in case:
        kw["alibi_slopes"] = alibi_slopes_for(4).to(cuda_device)
    if "pos" in case:
        kw["kv_pos"], kw["q_pos"] = _ladder(n_past, S, T, 3 if T == 4 else 2, cuda_device)
    if "shared" in case:
        g = torch.Generator().manual_seed(32)
        kw.update({n: (torch.randn((1, 96, Hkv, 64), generator=g) * 0.3).to(cuda_device,
                                                                             dtype)
                   for n in ("shared_k", "shared_v")})
    if "int8" in case:
        k, v = quantize_rows(k), quantize_rows(v)
    assert _k3_modes_run(q, k, v, npast, 0.125, case, **kw) < TOL


@pytest.mark.parametrize("index", [
    i for i, c in enumerate(kt.K3_CASES) if "alibi" in c[0] or "pos" in c[0]],
    ids=lambda i: kt.K3_CASES[i][1])
def test_k3_alibi_and_pos_at_model_shapes(cuda_device, index):
    """K3's ALiBi and self-extend cases of ``kernel_times.K3_CASES``, the
    main paths' shapes (Dh 128, 4096 rows): ALiBi at MPT-7B's and
    BLOOM-7B1's 32/32 heads (decode at B 1 and 4, n_past 700 and 3000,
    after 512 shared rows; prefill chunks of 101 tokens at n_past 0 and 128
    at 700), self-extend at the 8B's 32/8 heads (rows at i // 4 or at the
    CLI's ``-gan 4 -gaw 1024`` ladder, T 1 and 4); bf16 and int8; and both
    at the JAX tests' shape."""
    c = kt.k3_case(torch, cuda_device, kt.K3_CASES[index], 17 + index)
    assert _k3_modes_run(c["q"], c["k"], c["v"], c["npast"], c["scale"], c["mode"],
                         **c["kw"]) < TOL


def test_mha_alibi_and_pos_dispatch_on_card(cuda_device):
    """ALiBi or logical positions: G*T <= 128 takes K3 in its mode, more
    takes the counted einsum (no kernel, as in JAX); nothing raises."""
    from llama_cpp_gfx906_tpu_torch.ops.attention import alibi_slopes_for

    slopes = alibi_slopes_for(4).to(cuda_device)
    for T, pos, kern in ((2, False, flash_decode.modes["alibi"]),
                         (140, False, tatt.attend_einsum),
                         (2, True, flash_decode.modes["alibi_pos"]),
                         (140, True, tatt.attend_einsum)):
        q, k, v, npast, _ = _attn_case(9, 1, T, 4, 4, 64, 256, (30,), cuda_device,
                                       torch.bfloat16)
        kw = dict(alibi_slopes=slopes)
        if pos:
            kw["kv_pos"], kw["q_pos"] = _ladder((30,), 256, T, 2, cuda_device)
        before = kern.launches
        out, _, _ = tatt.mha_with_cache(q, k[:, :T].clone(), v[:, :T].clone(), k, v, npast,
                                        0.125, **kw)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        assert _rel(out, tatt.attend(q, k, v, npast, 0.125, **kw)) < TOL


@pytest.mark.parametrize("preset", ["tiny-mpt", "tiny-bloom-q8_0"])
def test_engine_alibi_card_matches_cpu(cuda_device, tmp_path, preset):
    """An ALiBi model on the card (the loop, K3's ALiBi mode; the fused loop
    captured in a graph) against the CPU's plain loop: prefill and 6 decode
    steps' logits within the Q4_K_M check (allclose at 8e-2), greedy tokens
    where the CPU's margin is clear, and ``decode_fused`` gives the card's
    ``decode_one`` tokens."""
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine

    path = write_synth(str(tmp_path / f"{preset}.gguf"), preset, seed=0)
    card = Engine.from_gguf(path, max_seq=256, device="cuda")
    cpu = Engine.from_gguf(path, max_seq=256, device="cpu")
    assert tllama.decode_route(card.params, card.cfg, card.kv) is None
    ids = list(range(3, 60))
    a, b = card.prefill(ids), cpu.prefill(ids)
    toks = []
    for _ in range(6):
        np.testing.assert_allclose(a, b, rtol=8e-2, atol=8e-2)
        tok = int(np.argmax(b))
        toks.append(tok)
        a, b = card.decode_one(tok), cpu.decode_one(tok)
    before = flash_decode.modes["alibi"].launches
    card.reset()
    first = int(np.argmax(card.prefill(ids)))
    fused = card.decode_fused(first, n_steps=5)
    card.reset()
    card.prefill(ids)
    loop, tok = [], first
    for _ in range(5):
        tok = int(np.argmax(card.decode_one(tok)))
        loop.append(tok)
    assert fused == loop
    assert flash_decode.modes["alibi"].launches > before


def test_engine_self_extend_card_matches_cpu(cuda_device, tmp_path):
    """Self-extend on the card: after ``seq_div`` the route is the loop with
    K3's positions mode, the fused step is captured anew (it was captured
    before ``seq_div``) and gives ``decode_one``'s tokens; the logits are
    held to the CPU's within the Q4_K_M check."""
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine

    path = write_synth(str(tmp_path / "small.gguf"), "small", seed=0)
    card = Engine.from_gguf(path, max_seq=256, device="cuda")
    cpu = Engine.from_gguf(path, max_seq=256, device="cpu")
    ids = list(range(3, 70))
    first = int(np.argmax(card.prefill(ids)))
    card.decode_fused(first, n_steps=4)  # captured without positions
    outs = []
    for eng in (card, cpu):
        eng.reset()
        eng.prefill(ids)
        eng.seq_div(0, len(ids), 4)
        outs.append([eng.decode_one(t) for t in (5, 6, 7)])
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=8e-2, atol=8e-2)
    assert tllama.decode_route(card.params, card.cfg, card.kv) is None
    fused_tokens = []
    for fused in (True, False):
        card.reset()
        card.prefill(ids)
        card.seq_div(0, len(ids), 4)
        if fused:
            before = kernels.device_counts()["flash_decode_pos"]
            fused_tokens.append(card.decode_fused(first, n_steps=6))
            assert kernels.device_counts()["flash_decode_pos"] - before >= 6 * 2
        else:
            tok, toks = first, []
            for _ in range(6):
                tok = int(np.argmax(card.decode_one(tok)))
                toks.append(tok)
            fused_tokens.append(toks)
    assert fused_tokens[0] == fused_tokens[1]


@pytest.mark.parametrize("kv_dtype", [None, "q8"])
def test_batched_engine_card_matches_cpu(cuda_device, kv_dtype):
    """tinydoc's pinned greedy prompts, all at once through the batched
    engine at f32 on the card (the decode step replayed from a CUDA graph)
    and on the CPU: the same tokens with an f32 cache, the pinned ones."""
    from llama_cpp_gfx906_tpu_torch.runtime.batch_engine import BatchedEngine, SamplerConfig

    with open(os.path.join(FIX, "tinydoc_expected.json")) as f:
        expected = json.load(f)
    path = os.path.join(FIX, "tinydoc-byte.f16.gguf")
    outs = []
    for dev in (cuda_device, "cpu"):
        eng = BatchedEngine.from_gguf(path, dtype=torch.float32, device=dev, n_slots=4,
                                      max_seq=128, n_chunk=8, kv_cache_dtype=kv_dtype)
        prompts = [eng.tokenizer.tokenize(p, add_special=True, parse_special=True)
                   for p in expected["greedy"]]
        slots = [eng.add_request(p, 24, SamplerConfig(temp=0.0)) for p in prompts]
        got = {s.id: [] for s in slots}
        while any(s.stop_reason is None for s in slots):
            for s, t, _ in eng.step():
                got[s.id].append(t)
        outs.append([got[s.id] for s in slots])
        if kv_dtype is None:
            assert outs[-1] == list(expected["greedy"].values())
    if kv_dtype is None:
        assert outs[0] == outs[1]
    else:  # int8 rows may round apart where card and CPU K differ by an ulp
        pairs = [(a, b) for x, y in zip(*outs) for a, b in zip(x, y)]
        assert sum(a == b for a, b in pairs) >= 0.9 * len(pairs)


# ---------------------------------------------------------------------------
# MoE: K8 (routed int8 expert matmul) and K6's MoE branch
# ---------------------------------------------------------------------------


def _experts_on(dev, qtype, E, N, K, seed, g16=False, **pad):
    raw = np.concatenate([_raw(qtype, N, K, seed + e).reshape(N, -1) for e in range(E)])
    pack = tq.pack_experts_int8_g16 if g16 else tq.pack_gguf_experts
    return pack(raw, qtype, (E, N, K), device=dev, **pad)


@pytest.mark.parametrize("P", [1, 2, 8, 13])
@pytest.mark.parametrize("qtype,g16,N,K", [
    (GGMLType.Q8_0, False, 1024, 4096), (GGMLType.Q8_0, False, 512, 3584),
    (GGMLType.Q6_K, False, 384, 768), (GGMLType.Q4_K, True, 256, 1280)])  # the last: mins
def test_rqmm_kernel_matches_plain(cuda_device, qtype, g16, N, K, P):
    qt = _experts_on(cuda_device, qtype, 8, N, K, 21, g16=g16)
    assert qt.fmt == "int8" and (qt.m is not None) == g16
    x = torch.randn((P, K), device=cuda_device).to(torch.bfloat16)
    idx = torch.randint(0, 8, (P,), dtype=torch.int32, device=cuda_device)
    before = tq.rqmm_int8.launches
    got = tq.rqmm_int8(x, qt, idx)
    ref = tq.rqmm_plain(x, qt, idx)
    torch.cuda.synchronize()
    assert tq.rqmm_int8.launches == before + 1
    assert got.shape == (P, N) and _rel(got, ref) < TOL
    via = tq.routed_quant_matmul(x, qt, idx.long())  # the dispatch takes K8
    assert tq.rqmm_int8.launches == before + 2 and _rel(via, ref) < TOL


def test_rqmm_replays_with_new_ids(cuda_device):
    """The expert ids are read on the device: a captured launch replays
    with the ids written into its buffer after the capture."""
    qt = _experts_on(cuda_device, GGMLType.Q8_0, 8, 512, 1024, 22)
    x = torch.randn((4, 1024), device=cuda_device).to(torch.bfloat16)
    idx = torch.tensor([0, 1, 2, 3], dtype=torch.int32, device=cuda_device)
    tq.rqmm_int8(x, qt, idx)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tq.rqmm_int8(x, qt, idx)
    idx.copy_(torch.tensor([7, 5, 7, 6], dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    assert _rel(out, tq.rqmm_plain(x, qt, idx)) < TOL


def _moe_engine(tmp_path, preset, dev):
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine

    return Engine.from_gguf(write_synth(str(tmp_path / f"{preset}.gguf"), preset, seed=4),
                            max_seq=512, device=dev)


@pytest.mark.parametrize("preset", ["tiny-moe", "tiny-moe-q8_0"])
@pytest.mark.parametrize("n_past", [0, 37, 300])
def test_k6_moe_matches_plain(cuda_device, tmp_path, preset, n_past):
    """K6's MoE branch (nib4c or int8 experts, the FF padded 768 -> 1024)
    against its plain version from the same state: the hidden state, the
    cache rows and the chosen expert ids of every layer."""
    eng = _moe_engine(tmp_path, preset, cuda_device)
    params, cfg = eng.params, eng.cfg
    kv0 = _filled_cache(cfg, 1, 512, (n_past,), cuda_device)
    assert k6._stream_ok(params, cfg, kv0, 1, 1)
    assert not k6._stream_ok(params, cfg, _filled_cache(cfg, 2, 512, (1, 2), cuda_device), 2, 1)
    for tok in (3, 101):
        x = params["tok_emb"][torch.tensor([[tok]], device=cuda_device)]
        kv, ref_kv = (_filled_cache(cfg, 1, 512, (n_past,), cuda_device) for _ in range(2))
        before = dict(kernels.counts())
        got = k6.fused_decode_step_streamed(params, cfg, x, kv)
        ids = []
        ref = k6.decode_layers_plain(params, cfg, x, ref_kv, ids_out=ids)
        torch.cuda.synchronize()
        now = kernels.counts()
        assert now["decode_stream"] == before["decode_stream"] + 1
        assert now["decode_stream_moe"] == before["decode_stream_moe"] + 1
        assert _rel(got, ref) < TOL
        assert _rel(kv.k, ref_kv.k) < TOL and _rel(kv.v, ref_kv.v) < TOL
        assert k6.last_expert_ids(params, kv).tolist() == [i[0].tolist() for i in ids]


@pytest.mark.parametrize("preset", ["tiny-moe", "tiny-moe-q8_0"])
def test_engine_moe_routes_match_cpu(cuda_device, tmp_path, monkeypatch, preset):
    """tiny-moe on the card: prefill through the dense expert path (K5 per
    expert for int8 experts), decode through the layer loop (K8 for int8
    experts, 3 launches a layer; the quantized gather for nib4c ones), then,
    with its layers declared large, through K6's MoE branch and
    decode_fused; each within the tolerance of the same steps on the CPU."""
    card, cpu = (_moe_engine(tmp_path, preset, d) for d in (cuda_device, "cpu"))
    q8 = preset.endswith("q8_0")
    assert tllama.decode_route(card.params, card.cfg, card.kv) is None  # tiny: the loop
    ids = card.tokenizer.tokenize("card against cpu", add_special=True)
    kernels.set_counts({})
    a0, b0 = card.prefill(ids), cpu.prefill(ids)
    assert _rel(torch.from_numpy(a0), torch.from_numpy(b0)) < TOL
    assert kernels.counts()["qmm_int8"] == (2 + 3 * 4) * 2 * q8  # qkv, o + 3 per expert
    feed = (5, 77, 300, 12)
    kernels.set_counts({})
    for tok in feed:
        a, b = card.decode_one(tok), cpu.decode_one(tok)
        assert np.abs(a - b).max() / np.abs(b).max() < TOL
    c = kernels.counts()
    assert (c["rqmm_int8"], c["routed_gather"]) == ((24, 0) if q8 else (0, 24))
    monkeypatch.setattr(tllama, "FUSED_LAYER_BYTES", 0)
    card.params.__dict__.pop("_decode_routes", None)
    assert tllama.decode_route(card.params, card.cfg, card.kv) == "k6"
    before = kernels.counts()["decode_stream_moe"]
    for tok in feed:
        a, b = card.decode_one(tok), _decode_logits(cpu, tok, k6.decode_layers_plain)
        assert np.abs(a - b).max() / np.abs(b).max() < TOL
    assert kernels.counts()["decode_stream_moe"] == before + 4
    toks = card.generate("card", n_predict=12, stop_on_eog=False)[1]
    fused = card.generate_fused("card", n_predict=11, stop_on_eog=False, chunk=5)[1]
    assert _greedy_consistent(card, "card", fused, toks[:11], TOL)
    before = kernels.device_counts()
    card.decode_fused(fused[-1], n_steps=5)
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in kernels.device_counts().items()}
    assert (ran["decode_stream_moe"], ran["gemv_int8"], ran["rqmm_int8"]) == (5, 5, 0)


# ---------------------------------------------------------------------------
# gemma3: the gemma modes of K6 and K7
# ---------------------------------------------------------------------------


def _gemma_engine(tmp_path, preset, dev, n_layers=None, max_seq=256):
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine

    path = write_synth(str(tmp_path / f"{preset}.gguf"), preset, seed=0,
                       n_layers=n_layers, n_vocab=512 if n_layers else None)
    return Engine.from_gguf(path, max_seq=max_seq, device=dev)


def _sub_stack(params, cfg, first, n):
    from llama_cpp_gfx906_tpu_torch.models.config import sub_config

    sub = ParamDict({"layers": torch.nn.ModuleList(list(params["layers"])[first:first + n])})
    return sub, sub_config(cfg, first, n)


@pytest.mark.parametrize("preset,n_layers,route,n_past", [
    ("tiny-gemma3", None, "k6", (40,)),
    ("tiny-gemma3", None, "k6", (5, 40, 200, 17)),
    ("tiny-gemma3-q8_0", None, "k7", (40,)),
    ("gemma3-4b-q4_k_m", 6, "k6", (3000,)),
    ("gemma3-4b-q4_k_m", 6, "k6", (700, 3000, 5, 1500)),
    ("gemma3-270m-q8_0", 6, "k7", (700,))])
def test_gemma_decode_kernels_match_plain(cuda_device, tmp_path, preset, n_layers, route,
                                          n_past):
    """K6's (B 1 and 4) and K7's gemma modes against the plain version on a
    gemma3 stack of 6 layers (five local, one global): the whole stack, and
    layers 4 and 5 (one local, one global) as a stack of their own that
    keeps their SWA flags, with n_past below and above the window; the
    hidden state and every cache row, from the same state."""
    max_seq = 256 if n_layers is None else 4096
    eng = _gemma_engine(tmp_path, preset, cuda_device, n_layers, max_seq)
    cfg, params = eng.cfg, eng.params
    assert cfg.swa_layers[:6] == (True,) * 5 + (False,)
    B = len(n_past)
    kern = k7.fused_decode_step if route == "k7" else k6.fused_decode_step_streamed
    gate = k7._fused_ok if route == "k7" else k6._stream_ok
    x = tllama.embed(params, cfg, torch.arange(B, device=cuda_device)[:, None] * 7 + 3)
    for sub, sub_cfg in ((params, cfg), _sub_stack(params, cfg, 4, 2)):
        kv, ref_kv = (_filled_cache(sub_cfg, B, max_seq, n_past, cuda_device)
                      for _ in range(2))
        assert gate(sub, sub_cfg, kv, B, 1)
        before, mode = kern.launches, kern.modes["gemma"].launches
        got = kern(sub, sub_cfg, x, kv)
        ref = k6.decode_layers_plain(sub, sub_cfg, x, ref_kv)
        torch.cuda.synchronize()
        assert (kern.launches, kern.modes["gemma"].launches) == (before + 1, mode + 1)
        assert torch.isfinite(got.float()).all() and _rel(got, ref) < TOL
        assert _rel(kv.k, ref_kv.k) < TOL and _rel(kv.v, ref_kv.v) < TOL


@pytest.mark.parametrize("preset,route", [("tiny-gemma3-q8_0", "k7"), ("tiny-gemma3", "k6")])
def test_engine_gemma_fused_route_matches_cpu(cuda_device, tmp_path, monkeypatch, preset,
                                              route):
    """tiny-gemma3 through ``Engine`` on the card: the decode route (the
    Q4_K_M one by K6, its layers declared large), its logits against the
    kernel's plain version on the CPU from the same state within 2e-2, and
    ``decode_fused``: one launch of the decode kernel's gemma mode per
    token and no head GEMV (the tied head is a dense bf16 product)."""
    if route == "k6":
        monkeypatch.setattr(tllama, "FUSED_LAYER_BYTES", 0)
    card = _gemma_engine(tmp_path, preset, cuda_device)
    cpu = _gemma_engine(tmp_path, preset, "cpu")
    assert tllama.decode_route(card.params, card.cfg, card.kv) == route
    ids = card.tokenizer.tokenize("card against cpu " * 4, add_special=True)
    assert len(ids) > 16  # past the window
    card.prefill(ids)
    cpu.prefill(ids)
    feed = (5, 77, 300, 12)
    a = [card.decode_one(tok) for tok in feed]
    b = [_decode_logits(cpu, tok, k6.decode_layers_plain) for tok in feed]
    for x, y in zip(a, b):
        assert np.abs(x - y).max() / np.abs(y).max() < TOL
    toks = card.generate("card", n_predict=12, stop_on_eog=False)[1]
    fused = card.generate_fused("card", n_predict=11, stop_on_eog=False, chunk=5)[1]
    assert _greedy_consistent(card, "card", fused, toks[:11], TOL)
    before = kernels.device_counts()
    for _ in range(2):
        card.decode_fused(fused[-1], n_steps=5)
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in kernels.device_counts().items()}
    name = "decode_step" if route == "k7" else "decode_stream"
    assert (ran[name], ran[f"{name}_gemma"], ran["gemv_int8"], ran["flash_decode"]) == (
        10, 10, 0, 0)


def test_gemma_decode_kernels_gelu_erf(cuda_device, tmp_path):
    """The gates admit gelu's erf form (JAX's do): K6 and K7 run it against
    the plain version on tiny-gemma3-q8_0 with ``act_fn`` "gelu_erf"."""
    import dataclasses

    eng = _gemma_engine(tmp_path, "tiny-gemma3-q8_0", cuda_device)
    cfg, params = dataclasses.replace(eng.cfg, act_fn="gelu_erf"), eng.params
    x = tllama.embed(params, cfg, torch.tensor([[11]], device=cuda_device))
    for kern in (k6.fused_decode_step_streamed, k7.fused_decode_step):
        kv, ref_kv = (_filled_cache(cfg, 1, 256, (40,), cuda_device) for _ in range(2))
        got = kern(params, cfg, x, kv)
        ref = k6.decode_layers_plain(params, cfg, x, ref_kv)
        torch.cuda.synchronize()
        assert _rel(got, ref) < TOL and _rel(kv.k, ref_kv.k) < TOL


# ---------------------------------------------------------------------------
# the split-K sums in a fixed order; the qwen modes of K6 and K7
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qtype,fold,K,N,M", [(GGMLType.Q6_K, True, 4096, 1024, 1),
                                              (GGMLType.Q4_K, True, 14336, 512, 8),
                                              (GGMLType.Q8_0, False, 1408, 2048, 4)])
def test_gemv_launches_are_bit_identical(cuda_device, qtype, fold, K, N, M):
    """K1 / K2 add their K segments in a fixed order: two launches on the
    same inputs give the same bits."""
    qt = tq.pack_gguf_tensor(_raw(qtype, N, K, 5), qtype, (N, K), fold_scales=fold,
                             device=cuda_device)
    x = torch.randn((M, K), device=cuda_device).to(torch.bfloat16)
    kern = tq.gemv_nib4c if qt.fmt == "nib4c" else tq.gemv_int8
    a, b = kern(x, qt), kern(x, qt)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and _rel(a, tq.gemv_plain(x, qt)) < TOL


@pytest.mark.parametrize("qtype,fold,K,N,M", [(GGMLType.Q6_K, True, 4096, 1024, 1),
                                              (GGMLType.Q4_K, True, 4096, 4096, 2),
                                              (GGMLType.Q4_K, False, 4096, 640, 8)])
def test_gemv_every_split_count_matches_plain(cuda_device, qtype, fold, K, N, M):
    """K1 / K2 at each split count that divides the segments (1: a block
    walks all of K and writes the output itself), each against the plain
    version and bit-identical over two launches."""
    qt = tq.pack_gguf_tensor(_raw(qtype, N, K, 6), qtype, (N, K), fold_scales=fold,
                             device=cuda_device)
    x = torch.randn((M, K), device=cuda_device).to(torch.bfloat16)
    seg, _ = tq._gemv_segment(qt)
    nseg = (K // 2 if qt.fmt == "nib4c" else K) // seg
    ref = tq.gemv_plain(x, qt)
    for splits in (d for d in range(1, nseg + 1) if nseg % d == 0):
        a, b = tq._gemv_launch(x, qt, splits), tq._gemv_launch(x, qt, splits)
        torch.cuda.synchronize()
        assert torch.equal(a, b) and _rel(a, ref) < TOL, splits


def test_rqmm_launches_are_bit_identical(cuda_device):
    """K8 adds its K splits in a fixed order, and an out-of-range expert id
    gives zeros."""
    E, N, K = 4, 512, 4096
    raw = np.concatenate([_raw(GGMLType.Q8_0, N, K, e) for e in range(E)])
    qt = tq.pack_gguf_experts(raw, GGMLType.Q8_0, (E, N, K), device=cuda_device)
    x = torch.randn((3, K), device=cuda_device).to(torch.bfloat16)
    idx = torch.tensor([2, 0, 7], dtype=torch.int32, device=cuda_device)
    a, b = tq.rqmm_int8(x, qt, idx), tq.rqmm_int8(x, qt, idx)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and bool((a[2] == 0).all())
    assert _rel(a[:2], tq.rqmm_plain(x[:2], qt, idx[:2])) < TOL


@pytest.mark.parametrize("preset,bias,route,n_past", [
    ("tiny-qwen3", True, "k6", (40,)),
    ("tiny-qwen3", True, "k6", (5, 40, 200, 17)),
    ("tiny-qwen3-q8_0", True, "k7", (40,)),
    ("tiny-qwen3moe", True, "k6", (40,)),
    ("tiny-qwen2moe", False, "k6", (40,)),
    ("tiny-qwen2moe-q8_0", False, "k6", (300,))])
def test_qwen_decode_kernels_match_plain(cuda_device, tmp_path, preset, bias, route,
                                         n_past):
    """K6's qwen modes (qk-norm without post-norms at B 1 and 4, MoE with
    qk-norm, the shared expert with its gate on a bias-free qwen2moe) and
    K7's qk-norm against the plain version from the same state, the hidden
    state and every cache row; a second launch gives the same bits; the
    shared expert's launch counts as ``decode_stream_shexp``."""
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine

    path = write_synth(str(tmp_path / f"{preset}.gguf"), preset, seed=0, attn_bias=bias)
    eng = Engine.from_gguf(path, max_seq=512, device=cuda_device)
    cfg, params = eng.cfg, eng.params
    B = len(n_past)
    kern = k7.fused_decode_step if route == "k7" else k6.fused_decode_step_streamed
    gate = k7._fused_ok if route == "k7" else k6._stream_ok
    x = tllama.embed(params, cfg, torch.arange(B, device=cuda_device)[:, None] * 7 + 3)
    kv, again, ref_kv = (_filled_cache(cfg, B, 512, n_past, cuda_device) for _ in range(3))
    assert gate(params, cfg, kv, B, 1)
    before = kernels.counts()
    got = kern(params, cfg, x, kv)
    ids = k6.last_expert_ids(params, kv).tolist() if cfg.n_experts else None
    got2 = kern(params, cfg, x, again)
    plain_ids = []
    ref = k6.decode_layers_plain(params, cfg, x, ref_kv, ids_out=plain_ids)
    torch.cuda.synchronize()
    now = kernels.counts()
    name = "decode_step" if route == "k7" else "decode_stream"
    mode = f"{name}_moe_gemma" if cfg.arch == "qwen3moe" else (
        f"{name}_moe" if cfg.n_experts else f"{name}_gemma")
    assert (now[name] - before[name], now[mode] - before[mode]) == (2, 2)
    assert now["decode_stream_shexp"] - before["decode_stream_shexp"] == (
        2 if cfg.arch == "qwen2moe" else 0)
    assert torch.equal(got, got2) and torch.equal(kv.k, again.k)
    assert torch.isfinite(got.float()).all() and _rel(got, ref) < TOL
    assert _rel(kv.k, ref_kv.k) < TOL and _rel(kv.v, ref_kv.v) < TOL
    if ids is not None:
        assert ids == [i[0].tolist() for i in plain_ids]


# ---------------------------------------------------------------------------
# gpt-oss: K5's and K8's nib4 modes and the other kernels at its shapes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def oss_gate():
    """gpt-oss-20b's gate experts on the card (``kernel_times.oss_experts``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return kt.oss_experts(torch.device("cuda"))


@pytest.mark.parametrize("case,M", kt.QMM_NIB4_CASES + (("tiny K 320 M=9", 9),))
def test_qmm_nib4_matches_plain(cuda_device, oss_gate, case, M):
    """K5-nib4 at gpt-oss's expert shape (and a 320-wide K, 5 steps of 32
    packed rows) against its plain version, through ``quant_matmul`` too,
    with mins; two launches give the same bits."""
    qt = tq.qt_expert(oss_gate, 3)
    if case.startswith("tiny"):
        raw = np.concatenate([_raw(GGMLType.Q4_0, 512, 320, 30 + e) for e in range(2)])
        qt = tq.qt_expert(tq.pack_gguf_experts(raw, GGMLType.Q4_0, (2, 512, 320),
                                               device=cuda_device), 1)
    assert qt.fmt == "nib4" and qt.m is not None and tq.qmm_tileable(qt)
    x = torch.randn((M, qt.K), device=cuda_device).to(torch.bfloat16)
    before = tq.qmm_nib4.launches
    got = tq.qmm_nib4(x, qt)
    again = tq.qmm_nib4(x, qt)
    via = tq.quant_matmul(x[None], qt)[0]
    ref = tq.qmm_nib4_plain(x, qt)
    torch.cuda.synchronize()
    assert tq.qmm_nib4.launches == before + 3
    assert got.shape == (M, qt.N) and _rel(got, ref) < TOL and _rel(via, ref) < TOL
    assert torch.equal(got, again)


@pytest.mark.parametrize("case,P", kt.RQMM_NIB4_CASES + (("ids past E", 3),))
def test_rqmm_nib4_matches_plain(cuda_device, oss_gate, case, P):
    """K8-nib4 at gpt-oss's gate experts for 4 and 8 pairs, with mins,
    through ``routed_quant_matmul`` too; two launches give the same bits; an
    expert id past E gives a row of zeros."""
    rng = np.random.default_rng(P)
    ids = kt.oss_pair_ids(rng, P) if P % 4 == 0 else np.array([5, kt.OSS_E, 5])
    idx = torch.tensor(ids, dtype=torch.int32, device=cuda_device)
    x = torch.randn((P, kt.OSS_D), device=cuda_device).to(torch.bfloat16)
    before = tq.rqmm_nib4.launches
    got = tq.rqmm_nib4(x, oss_gate, idx)
    again = tq.rqmm_nib4(x, oss_gate, idx)
    torch.cuda.synchronize()
    assert tq.rqmm_nib4.launches == before + 2 and torch.equal(got, again)
    live = idx < kt.OSS_E
    ref = tq.rqmm_nib4_plain(x[live], oss_gate, idx[live])
    assert _rel(got[live], ref) < TOL and not got[~live].any()
    if live.all():
        via = tq.routed_quant_matmul(x, oss_gate, idx.long())
        assert tq.rqmm_nib4.launches == before + 3 and _rel(via, ref) < TOL


def test_rqmm_nib4_replays_with_new_ids(cuda_device, oss_gate):
    """K8-nib4 reads its ids on the device: a captured launch replays with
    the ids written after the capture (the gpt-oss decode graph)."""
    x = torch.randn((4, kt.OSS_D), device=cuda_device).to(torch.bfloat16)
    idx = torch.tensor([0, 1, 2, 3], dtype=torch.int32, device=cuda_device)
    tq.rqmm_nib4(x, oss_gate, idx)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tq.rqmm_nib4(x, oss_gate, idx)
    idx.copy_(torch.tensor([31, 17, 9, 30], dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    assert _rel(out, tq.rqmm_nib4_plain(x, oss_gate, idx)) < TOL


@pytest.mark.parametrize("name,case,gtype,K,N,pad", kt.OSS_GEMV_CASES)
def test_gemv_at_gpt_oss_shapes(cuda_device, name, case, gtype, K, N, pad):
    """K1 at K 2880 (64-row segments, with mins; the head's one split) and
    K2 at N 2880 (a ragged last 128-column tile), against the plain
    version, bit-identical over two launches."""
    qt = kt.gemv_weights(np.random.default_rng(3), gtype, K, N, pad, cuda_device)
    x = torch.randn((1, K), device=cuda_device).to(torch.bfloat16)
    kern = getattr(tq, name)
    got = kern(x, qt)
    again = kern(x, qt)
    torch.cuda.synchronize()
    assert got.shape == (1, N) and _rel(got, tq.gemv_plain(x, qt)) < TOL
    assert torch.equal(got, again)


@pytest.mark.parametrize("case,M", kt.OSS_QMM_INT8_CASES)
def test_qmm_int8_at_k_2880(cuda_device, case, M):
    """K5's int8 mode on gpt-oss's fused q|k|v (Q4_0 with mins, K 2880)."""
    qt = tq.pack_gguf_tensor(_raw(GGMLType.Q4_0, 5120, 2880, 4), GGMLType.Q4_0,
                             (5120, 2880), device=cuda_device)
    assert qt.fmt == "int8" and qt.m is not None and tq.qmm_tileable(qt)
    x = torch.randn((M, 2880), device=cuda_device).to(torch.bfloat16)
    got = tq.qmm_int8(x, qt)
    torch.cuda.synchronize()
    assert _rel(got, tq.qmm_plain(x, qt)) < TOL and torch.equal(got, tq.qmm_int8(x, qt))


@pytest.mark.parametrize("index", range(len(kt.OSS_ATTN_CASES)))
def test_attention_at_gpt_oss_shapes(cuda_device, index):
    """K3 at gpt-oss's 64/8 heads of 64 with sinks, window 128 and full,
    against its plain version (K4's gpt-oss cases: ``test_k4_at_model_shapes``)."""
    from llama_cpp_gfx906_tpu_torch.ops.flash_decode import flash_decode_plain

    _, _, T, n_past, window = kt.OSS_ATTN_CASES[index]
    c = kt.oss_attn_case(torch, cuda_device, T, n_past, window, 40 + index)
    args = (c["q"], c["k"], c["v"], c["npast"], c["scale"], window, 0.0, c["sinks"])
    got = flash_decode(*args)
    torch.cuda.synchronize()
    assert _rel(got, flash_decode_plain(*args)) < TOL and torch.equal(got, flash_decode(*args))


def test_engine_gpt_oss_card_matches_cpu(cuda_device, tmp_path):
    """tiny-gpt-oss on the card (the per-layer loop: K5-nib4 for the gate
    and up experts at prefill, K8-nib4 at decode; the fused loop captured
    in a graph) against the CPU's plain loop: the prefill and 6 decode
    steps, the CPU following the card's routes (``kernel_times.RouteLog``:
    the devices round the bf16 activations differently, so a router
    near-tie may pick another expert on each), every expert of the card's
    that the CPU ranks below its own top k explained by the two devices'
    router logits, and the logits within the Q4_K_M check (allclose at
    8e-2); ``decode_fused`` gives the card's ``decode_one`` tokens."""
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine

    path = write_synth(str(tmp_path / "tiny-gpt-oss.gguf"), "tiny-gpt-oss", seed=0)
    card = Engine.from_gguf(path, max_seq=256, device="cuda")
    cpu = Engine.from_gguf(path, max_seq=256, device="cpu")
    L = card.cfg.n_layers
    assert tllama.decode_route(card.params, card.cfg, card.kv) is None
    ids = list(range(3, 60))
    k5, k8 = tq.qmm_nib4.launches, tq.rqmm_nib4.launches
    tok = None
    for _ in range(7):
        with kt.RouteLog() as routes:
            a = card.prefill(ids) if tok is None else card.decode_one(tok)
        with kt.RouteLog(replay=routes.calls) as replayed:
            b = cpu.prefill(ids) if tok is None else cpu.decode_one(tok)
        assert replayed.unexplained(routes) <= 1
        np.testing.assert_allclose(a, b, rtol=8e-2, atol=8e-2)
        tok = int(np.argmax(b))
    assert tq.qmm_nib4.launches == k5 + 2 * 4 * L  # gate and up, 4 experts
    assert tq.rqmm_nib4.launches == k8 + 6 * 2 * L
    card.reset()
    first = int(np.argmax(card.prefill(ids)))
    fused = card.decode_fused(first, n_steps=5)
    card.reset()
    card.prefill(ids)
    loop, tok = [], first
    for _ in range(5):
        tok = int(np.argmax(card.decode_one(tok)))
        loop.append(tok)
    assert fused == loop
