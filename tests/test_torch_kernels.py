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

from llama_cpp_gfx906_tpu_torch.gguf.constants import GGMLType
from llama_cpp_gfx906_tpu_torch.gguf.quants import quantize
from llama_cpp_gfx906_tpu_torch.ops import attention as tatt
from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as tq
from llama_cpp_gfx906_tpu_torch.ops.flash_attention import flash_attention
from llama_cpp_gfx906_tpu_torch.ops.flash_decode import flash_decode
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
    return quantize(rng.standard_normal((N, K)).astype(np.float32), qtype)


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
