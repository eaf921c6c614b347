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
        x = layers_fn(p, cfg, p["tok_emb"][torch.tensor([[tok]], device=eng.device)], eng.kv)
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
    token (read from a profiler trace: graph replays bypass the wrappers'
    counts)."""
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
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(2):  # two chunks of replays
            card.decode_fused(fused[-1], n_steps=5)
        torch.cuda.synchronize()
    traced = kernels.traced_launches(prof)
    assert (traced[route_kernel], traced["gemv_int8"], traced["gemv_nib4c"],
            traced["flash_decode"]) == (10, 10, 0, 0)
