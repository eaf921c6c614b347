"""Port parity end to end: GGUF writer, SPM tokenizer, weight loading and the
engine (llama_cpp_gfx906_tpu_torch) against the JAX package, at f32 on the
CPU.

Logit tolerance: max |port - jax| / max |jax| < 1e-2.  The JAX CPU path
dequantizes every quantized weight to bf16 (quant_matmul_xla); the port's
GEMV plain version (decode, M <= 8) keeps f32 weights, so the two differ by
bf16 weight rounding, ~0.2% of the logit scale here.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_cpp_gfx906_tpu.gguf import GGMLType, quantize
from llama_cpp_gfx906_tpu.gguf.writer import GGUFWriter as JWriter
from llama_cpp_gfx906_tpu.runtime.engine import Engine as JEngine
from llama_cpp_gfx906_tpu.tokenizers import tokenizer_from_gguf as j_tokenizer
from llama_cpp_gfx906_tpu.gguf.reader import GGUFReader as JReader
from llama_cpp_gfx906_tpu_torch.gguf.reader import GGUFReader
from llama_cpp_gfx906_tpu_torch.gguf.writer import GGUFWriter
from llama_cpp_gfx906_tpu_torch.models.llama import KVCache, forward
from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
from llama_cpp_gfx906_tpu_torch.runtime.weights import params_from_jax
from llama_cpp_gfx906_tpu_torch.tokenizers import tokenizer_from_gguf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
TINYDOC = os.path.join(FIX, "tinydoc-byte.f16.gguf")
LOGIT_TOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small CPU ops, fastest on one thread; under
    pytest-xdist, torch's default of one thread per core in every worker
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.fixture(scope="module")
def synth_tiny(tmp_path_factory):
    """The tiny synthetic Q4_K_M written by the JAX package's script."""
    path = str(tmp_path_factory.mktemp("synth") / "tiny.gguf")
    subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "make_synth_gguf.py"),
                    path, "--preset", "tiny"], check=True, capture_output=True)
    return path


def _write_qnormal(path):
    """A tiny llama whose Q4_K / Q6_K tensors quantize seeded normal floats
    (the synthetic pattern's logits are nearly flat; these are not)."""
    rng = np.random.default_rng(0)
    L, D, H, KVH, DH, F, V = 2, 256, 4, 2, 64, 512, 320
    w = JWriter(path, "llama")
    for k, v in [("llama.block_count", L), ("llama.embedding_length", D),
                 ("llama.attention.head_count", H), ("llama.attention.head_count_kv", KVH),
                 ("llama.attention.key_length", DH), ("llama.feed_forward_length", F),
                 ("llama.context_length", 256), ("llama.vocab_size", V),
                 ("tokenizer.ggml.bos_token_id", 0), ("tokenizer.ggml.eos_token_id", 1)]:
        w.add_uint32(k, v)
    w.add_float32("llama.attention.layer_norm_rms_epsilon", 1e-5)
    w.add_float32("llama.rope.freq_base", 10000.0)
    w.add_string("tokenizer.ggml.model", "llama")
    toks = ["<s>", "</s>", "<unk>"] + [f"<0x{b:02X}>" for b in range(256)]
    toks += [f"w{i}" for i in range(V - len(toks))]
    w.add_array("tokenizer.ggml.tokens", toks)
    w.add_array("tokenizer.ggml.scores", [0.0] * V)
    w.add_array("tokenizer.ggml.token_type", [3, 3, 2] + [6] * 256 + [1] * (V - 259))

    def add(name, n_out, n_in, qtype, std):
        arr = (rng.standard_normal((n_out, n_in)) * std).astype(np.float32)
        w.add_tensor(name, quantize(arr, qtype), ggml_type=qtype, raw_ne=(n_in, n_out))

    w.add_tensor("token_embd.weight", (rng.standard_normal((V, D))).astype(np.float16))
    w.add_tensor("output_norm.weight", np.ones(D, np.float32))
    add("output.weight", V, D, GGMLType.Q6_K, 0.1)
    for i in range(L):
        w.add_tensor(f"blk.{i}.attn_norm.weight", np.ones(D, np.float32))
        w.add_tensor(f"blk.{i}.ffn_norm.weight", np.ones(D, np.float32))
        add(f"blk.{i}.attn_q.weight", H * DH, D, GGMLType.Q4_K, 0.08)
        add(f"blk.{i}.attn_k.weight", KVH * DH, D, GGMLType.Q4_K, 0.08)
        add(f"blk.{i}.attn_v.weight", KVH * DH, D, GGMLType.Q6_K, 0.08)
        add(f"blk.{i}.attn_output.weight", D, H * DH, GGMLType.Q4_K, 0.05)
        add(f"blk.{i}.ffn_gate.weight", F, D, GGMLType.Q4_K, 0.06)
        add(f"blk.{i}.ffn_up.weight", F, D, GGMLType.Q4_K, 0.06)
        add(f"blk.{i}.ffn_down.weight", D, F, GGMLType.Q4_K, 0.04)
    w.write()


@pytest.fixture(scope="module")
def qnormal(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("qnormal") / "qnormal.gguf")
    _write_qnormal(path)
    return path


def _engines(path, max_seq=64):
    je = JEngine.from_gguf(path, max_seq=max_seq, dtype=jnp.float32)
    te = Engine.from_gguf(path, max_seq=max_seq, dtype=torch.float32, device="cpu")
    return je, te


@pytest.mark.parametrize("model", ["synth_tiny", "qnormal"])
def test_engine_logits_and_greedy_match(model, request):
    je, te = _engines(request.getfixturevalue(model))
    ids = je.tokenizer.tokenize("the quick brown fox jumps", add_special=True,
                                parse_special=True)
    assert len(ids) > 8  # prefill takes the M > 8 dequant matmul
    je.reset()
    te.reset()
    a, b = je.prefill(ids), te.prefill(ids)
    assert b.shape == (te.cfg.n_vocab,) and rel_err(b, a) < LOGIT_TOL
    tok = int(np.argmax(a))
    for _ in range(8):
        a, b = je.decode_one(tok), te.decode_one(tok)
        assert rel_err(b, a) < LOGIT_TOL
        tok = int(np.argmax(a))
    assert te.n_past == je.n_past
    # "zz": the top-2 logit margin stays >= 0.14 on both models over these 8
    # steps, well above the bf16-vs-f32 weight difference (<= 0.08)
    jt = je.generate("zz", n_predict=8, stop_on_eog=False)[1]
    tt = te.generate("zz", n_predict=8, stop_on_eog=False)[1]
    assert tt == jt


def test_qnormal_layouts_match_jax(qnormal):
    """Default load: Q4_K q|k fused as nib4c, Q6_K v apart as int8, folded
    scales, and every plane byte-equal to the JAX loader's per-layer slice."""
    je, te = _engines(qnormal)
    jl, tl = je.params["layers"], te.params["layers"]
    assert sorted(tl[0].keys()) == sorted(jl.keys())
    assert tl[0]["wqk_fused"].fmt == "nib4c" and tl[0]["wv"].fmt == "int8"
    for key, jv in jl.items():
        for i, layer in enumerate(tl):
            tv = layer[key]
            for name in (("q", "s", "m", "sd", "md") if hasattr(jv, "fmt") else (None,)):
                a = np.asarray(getattr(jv, name) if name else jv)
                b = getattr(tv, name) if name else tv
                if name and getattr(jv, name) is None:
                    assert b is None
                    continue
                assert a[i].tobytes() == b.numpy().tobytes(), (key, name, i)


def test_params_from_jax_same_logits(qnormal):
    je, te = _engines(qnormal)
    np_params = jax.tree_util.tree_map(np.asarray, je.params)
    params = params_from_jax(np_params, te.cfg, "cpu")
    toks = torch.tensor([[0, 5, 77, 300, 12, 9]])
    outs = []
    for p in (params, te.params):
        kv = KVCache.create(te.cfg, 1, 16, torch.float32)
        logits, kv = forward(p, te.cfg, toks, kv)
        step, _ = forward(p, te.cfg, torch.tensor([[42]]), kv)
        outs.append((logits.numpy(), step.numpy()))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("keep_quantized", [True, False])
def test_tinydoc_pinned_greedy_and_ppl(keep_quantized):
    """Both loaders (F16 weights: dense either way, fused or not)."""
    with open(os.path.join(FIX, "tinydoc_expected.json")) as f:
        expected = json.load(f)
    eng = Engine.from_gguf(TINYDOC, max_seq=192, dtype=torch.float32, device="cpu",
                           keep_quantized=keep_quantized)
    assert ("wqkv_fused" in eng.params["layers"][0]) == keep_quantized
    for prompt, want in expected["greedy"].items():
        _, toks = eng.generate(prompt, n_predict=len(want), stop_on_eog=False)
        assert toks == want, prompt
    held = expected["held_ids"]
    kv = KVCache.create(eng.cfg, 1, len(held) - 1, torch.float32)
    logits, _ = forward(eng.params, eng.cfg, torch.tensor([held[:-1]]), kv)
    logp = torch.log_softmax(logits[0], -1)[torch.arange(len(held) - 1),
                                            torch.tensor(held[1:])]
    ppl = float(torch.exp(-logp.mean()))
    assert abs(ppl - expected["ppl"]) / expected["ppl"] < 0.01


@pytest.mark.parametrize("model", ["tinydoc", "synth_tiny"])
def test_spm_tokenizer_matches(model, request):
    path = TINYDOC if model == "tinydoc" else request.getfixturevalue("synth_tiny")
    jt, tt = j_tokenizer(JReader(path)), tokenizer_from_gguf(GGUFReader(path))
    for text in ["", "Hello world", "  two  spaces", "quantized <s> tensors </s>",
                 "naïve café ☃ 日本", "tok5 tok17tok3", "line\nbreak\ttab"]:
        for special in (True, False):
            ids = tt.tokenize(text, add_special=special, parse_special=special)
            assert ids == jt.tokenize(text, add_special=special, parse_special=special)
            assert tt.detokenize(ids) == jt.detokenize(ids)


def test_writer_byte_identical(tmp_path):
    rng = np.random.default_rng(3)
    f32 = rng.standard_normal((8, 64)).astype(np.float32)
    f16 = rng.standard_normal((4, 32)).astype(np.float16)
    q4k = quantize(rng.standard_normal((2, 256)).astype(np.float32), GGMLType.Q4_K)
    files = []
    for cls in (JWriter, GGUFWriter):
        path = str(tmp_path / f"{cls.__module__.split('.')[0]}.gguf")
        w = cls(path, "llama")
        w.add_uint32("llama.block_count", 3)
        w.add_float32("llama.rope.freq_base", 500000.0)
        w.add_bool("general.flag", True)
        w.add_string("general.name", "writer-parity ☃")
        w.add_array("tokenizer.ggml.tokens", ["<s>", "a", "b"])
        w.add_array("tokenizer.ggml.scores", [0.0, -1.5, 2.25])
        w.add_array("tokenizer.ggml.token_type", [3, 1, 1])
        w.add_array("general.ints", np.arange(5, dtype=np.int32))
        w.add_kv("general.count", 7)
        w.add_tensor("a.f32", f32)
        w.add_tensor("b.f16", f16)
        w.add_tensor("c.q4_0", f32, ggml_type=GGMLType.Q4_0)
        w.add_tensor("d.q8_0", f32, ggml_type=GGMLType.Q8_0)
        w.add_tensor("e.q4_k", q4k, ggml_type=GGMLType.Q4_K, raw_ne=(256, 2))
        w.add_tensor("f.vec", np.ones(7, np.float32))
        w.write()
        files.append(open(path, "rb").read())
    assert files[0] == files[1]
    r = GGUFReader(path)
    np.testing.assert_array_equal(r.tensors["a.f32"].to_f32(), f32)
    np.testing.assert_allclose(r.tensors["c.q4_0"].to_f32(), f32, atol=0.5)


def test_greedy_sampler_matches_jax():
    from llama_cpp_gfx906_tpu.sampling.samplers import SamplerChain as JChain
    from llama_cpp_gfx906_tpu.sampling.samplers import SamplerParams as JParams
    from llama_cpp_gfx906_tpu_torch.sampling.samplers import SamplerChain, SamplerParams

    rng = np.random.default_rng(5)
    for _ in range(20):
        logits = rng.standard_normal(300).astype(np.float32)
        prev = [int(t) for t in rng.integers(0, 300, 40)]
        kw = dict(greedy=True, penalty_repeat=1.5, penalty_freq=0.3,
                  penalty_present=0.2, penalty_last_n=16,
                  logit_bias={int(np.argmax(logits)): -2.0})
        assert (SamplerChain(SamplerParams(**kw), 300).sample(logits, prev)
                == JChain(JParams(**kw), 300).sample(logits, prev))
    with pytest.raises(NotImplementedError):
        SamplerChain(SamplerParams(temp=0.8), 300)
