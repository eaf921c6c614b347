"""The ALiBi families (mpt, bloom) in the port (llama_cpp_gfx906_tpu_torch)
against the JAX package, on the CPU.

K3's ALiBi mode: the plain version of ``flash_decode`` (what the wrapper
runs on a CPU tensor) against the JAX kernel in interpret mode on the cases
of tests/test_flash_decode.py:157-275 that carry ALiBi or a shared segment
(the self-extend ones are in test_torch_self_extend.py).  The slice on the
tiny presets of ``tools/synth_gguf.py`` (``tiny-mpt``: 2 layers, hidden
256, 4 heads of 64, no biases; ``tiny-bloom``: hidden 768, 12 heads, so
the slopes' tail is used, with every bias and the embedding norm; each in
the Q4_K_M mix and in Q8_0): the slopes, LayerNorm, the config, the
loader's planes (the fused ``attn_qkv`` split and fused again), the
forward, both engines and the decode gates; and the JAX package's HF-built
fixtures (tests/test_wave4_archs.py:218-265) through the port's loader.

Tolerances, each the one the JAX package's own test of the same thing
uses: K3 2e-2 of max |jax| (3e-2 over an int8 cache), the forward's logits
2e-2 and the same argmax, engine logits at f32 1e-2 with greedy tokens equal
where the JAX top-2 margin exceeds twice that step's error (the JAX CPU
path decodes with bf16-dequantized weights, the port's GEMV plain version
in f32), the HF fixtures 3e-3 (assert_allclose rtol = atol), the slopes
and the loader's planes exact, LayerNorm 1e-6 (f32) or one bf16 ulp.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_cpp_gfx906_tpu.gguf import GGUFReader as JReader
from llama_cpp_gfx906_tpu.models.config import config_from_gguf as j_config_from_gguf
from llama_cpp_gfx906_tpu.models.llama import KVCache as JKV
from llama_cpp_gfx906_tpu.models.llama import forward as j_forward
from llama_cpp_gfx906_tpu.ops import decode_stream as jk6
from llama_cpp_gfx906_tpu.ops.attention import alibi_slopes_for as j_slopes
from llama_cpp_gfx906_tpu.ops.decode_step import _fused_ok as j_fused_ok
from llama_cpp_gfx906_tpu.ops.flash_decode import flash_decode as j_flash_decode
from llama_cpp_gfx906_tpu.ops.norms import layer_norm as j_layer_norm
from llama_cpp_gfx906_tpu.runtime.batch_engine import BatchedEngine as JBatched
from llama_cpp_gfx906_tpu.runtime.batch_engine import SamplerConfig as JSampler
from llama_cpp_gfx906_tpu.runtime.engine import Engine as JEngine
from llama_cpp_gfx906_tpu.runtime.weights import load_llama_params as j_load_dense
from llama_cpp_gfx906_tpu.tokenizers import tokenizer_from_gguf as j_tokenizer
from llama_cpp_gfx906_tpu_torch.gguf.reader import GGUFReader
from llama_cpp_gfx906_tpu_torch.models.config import config_from_gguf
from llama_cpp_gfx906_tpu_torch.models.llama import KVCache, decode_route, forward
from llama_cpp_gfx906_tpu_torch.ops import decode_step as k7
from llama_cpp_gfx906_tpu_torch.ops import decode_stream as k6
from llama_cpp_gfx906_tpu_torch.ops.attention import alibi_slopes_for
from llama_cpp_gfx906_tpu_torch.ops.flash_decode import flash_decode
from llama_cpp_gfx906_tpu_torch.ops.kv_quant import QuantKV
from llama_cpp_gfx906_tpu_torch.ops.norms import layer_norm
from llama_cpp_gfx906_tpu_torch.runtime.batch_engine import BatchedEngine, SamplerConfig
from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine, load_model
from llama_cpp_gfx906_tpu_torch.runtime.weights import load_llama_params, params_from_jax
from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

PRESETS = ("tiny-mpt", "tiny-mpt-q8_0", "tiny-bloom", "tiny-bloom-q8_0")
FIELDS = ("arch", "n_layers", "n_embd", "n_heads", "n_kv_heads", "head_dim", "n_ff",
          "n_vocab", "rms_eps", "norm_type", "pos_emb", "alibi", "ffn_gated", "act_fn",
          "attn_bias", "qk_norm", "post_attn_norm", "post_ffn_norm")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("alibi")
    return {p: write_synth(str(d / f"{p}.gguf"), p, seed=0) for p in PRESETS}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


# ---------------------------------------------------------------------------
# the slopes, LayerNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_heads", [4, 12, 32, 40, 80])
def test_alibi_slopes_match_jax(n_heads):
    """The per-head slopes, the non-power-of-two tail included, exactly."""
    got = alibi_slopes_for(n_heads)
    assert got.dtype == torch.float32 and got.shape == (n_heads,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_slopes(n_heads)))


@pytest.mark.parametrize("dtype,bias", [("float32", True), ("float32", False),
                                        ("bfloat16", True)])
def test_layer_norm_matches_jax(dtype, bias):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 5, 96)) * 3 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    b = (0.1 * rng.standard_normal(96)).astype(np.float32) if bias else None
    want = j_layer_norm(jnp.asarray(x, dtype), jnp.asarray(w),
                        None if b is None else jnp.asarray(b), 1e-5)
    got = layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(w),
                     None if b is None else torch.from_numpy(b), 1e-5)
    want = np.asarray(want, np.float32)
    tol = 1e-6 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# K3's plain version against the JAX kernel (interpret mode)
# ---------------------------------------------------------------------------


def k3_inputs(seed, B=2, T=1, Hq=4, Hkv=2, D=64, S=256, S0=0):
    """One case as numpy arrays: q, the caches (already holding the new
    rows), n_past, and shared rows of length S0 (tests/test_flash_decode.py
    ``make_case`` / ``_shared``)."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, T, Hq, D)) * 0.3).astype(np.float32)
    kv = (rng.standard_normal((2, B, S, Hkv, D)) * 0.3).astype(np.float32)
    n_past = rng.integers(3, S - T - 1, size=B).astype(np.int32)
    sh = (rng.standard_normal((2, 1, S0, Hkv, D)) * 0.3).astype(np.float32) if S0 else None
    return q, kv, n_past, sh


def run_k3(q, kv, n_past, sh=None, quant=False, **kw):
    """(port, jax): K3's plain version and the JAX kernel in interpret mode
    on the same inputs; ``kw`` as flash_decode's (numpy values)."""
    scale = q.shape[-1] ** -0.5
    if quant:
        from llama_cpp_gfx906_tpu.ops.kv_quant import quantize_rows

        jk, jv = quantize_rows(jnp.asarray(kv[0])), quantize_rows(jnp.asarray(kv[1]))
        tk = QuantKV(torch.from_numpy(np.array(jk.q)), torch.from_numpy(np.array(jk.s)))
        tv = QuantKV(torch.from_numpy(np.array(jv.q)), torch.from_numpy(np.array(jv.s)))
    else:
        jk, jv = jnp.asarray(kv[0]), jnp.asarray(kv[1])
        tk, tv = torch.from_numpy(kv[0]), torch.from_numpy(kv[1])
    if sh is not None:
        kw = dict(kw, shared_k=sh[0], shared_v=sh[1])
    jkw = {k: (None if v is None else (jnp.asarray(v) if isinstance(v, np.ndarray) else v))
           for k, v in kw.items()}
    tkw = {k: (None if v is None else (torch.from_numpy(np.array(v))
                                        if isinstance(v, np.ndarray) else v))
           for k, v in kw.items()}
    want = j_flash_decode(jnp.asarray(q), jk, jv, jnp.asarray(n_past), scale,
                          interpret=True, **jkw)
    got = flash_decode(torch.from_numpy(q), tk, tv, torch.from_numpy(n_past), scale, **tkw)
    return got.float().numpy(), np.asarray(want, np.float32)


def slopes4():
    return np.asarray(j_slopes(4))


K3_CASES = {
    # name: (inputs, flash_decode keywords, tol)
    "alibi_gqa": (dict(), lambda: dict(alibi_slopes=slopes4()), 2e-2),
    "alibi_mha_t3": (dict(T=3, Hkv=4), lambda: dict(alibi_slopes=slopes4()), 2e-2),
    "alibi_softcap_window": (dict(S=384), lambda: dict(
        alibi_slopes=slopes4(), logit_softcap=25.0, sliding_window=96), 2e-2),
    "alibi_quant_kv": (dict(quant=True), lambda: dict(alibi_slopes=slopes4()), 3e-2),
    "shared_prefix": (dict(S0=40), dict, 2e-2),
    "shared_prefix_t4_block_multiple": (dict(T=4, S0=128), dict, 2e-2),
    "shared_prefix_quant_kv": (dict(quant=True, S0=70), dict, 3e-2),
    "shared_prefix_sinks_softcap": (dict(S0=40), lambda: dict(
        sinks=np.random.default_rng(5).standard_normal(4).astype(np.float32),
        logit_softcap=30.0), 2e-2),
    "shared_prefix_alibi_window": (dict(S=384, S0=96), lambda: dict(
        alibi_slopes=slopes4(), sliding_window=160), 2e-2),
}


@pytest.mark.parametrize("name", list(K3_CASES))
def test_k3_plain_matches_jax_kernel(name):
    """K3's plain version (ALiBi after the softcap and before the mask; the
    shared rows at logical 0..S0-1) against the JAX kernel in interpret
    mode."""
    shape, kw, tol = K3_CASES[name]
    shape = dict(shape)
    quant = shape.pop("quant", False)
    q, kv, n_past, sh = k3_inputs(11, **shape)
    got, want = run_k3(q, kv, n_past, sh, quant=quant, **kw())
    assert _rel(got, want) < tol


def test_k3_alibi_moves_the_output():
    """The slopes reach the scores: without them the output moves."""
    q, kv, n_past, _ = k3_inputs(12)
    with_slopes, _ = run_k3(q, kv, n_past, alibi_slopes=slopes4() * 4)
    without, _ = run_k3(q, kv, n_past)
    assert _rel(with_slopes, without) > 0.1


# ---------------------------------------------------------------------------
# config, loader, forward and engines on the synthetic files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", PRESETS)
def test_config_matches_jax(files, preset):
    """mpt: LayerNorm, no positional embedding, ALiBi, ungated gelu-erf;
    bloom: the same with q/k/v biases and gelu-tanh; eps from
    ``{arch}.attention.layer_norm_epsilon``."""
    jcfg = j_config_from_gguf(JReader(files[preset]))
    cfg = config_from_gguf(GGUFReader(files[preset]))
    for f in FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert (cfg.norm_type, cfg.pos_emb, cfg.alibi, cfg.ffn_gated) == ("layer", "none",
                                                                      True, False)
    assert cfg.act_fn == ("gelu_erf" if cfg.arch == "mpt" else "gelu_tanh")


@functools.lru_cache(maxsize=None)
def _engines(path):
    """The JAX and the port's engines on ``path`` at f32."""
    return (JEngine.from_gguf(path, max_seq=256, dtype=jnp.float32),
            Engine.from_gguf(path, max_seq=256, dtype=torch.float32, device="cpu"))


@pytest.mark.parametrize("preset", PRESETS)
def test_loader_matches_jax(files, preset):
    """Byte-equal planes and vectors as the JAX loader's: the fused
    ``attn_qkv`` split by rows and fused again (``wqkv_fused``, with
    ``bqkv_fused`` for bloom), ``bo``, the ungated ``w_up`` / ``w_down`` and
    their biases, the norms' biases and the model-level ``tok_norm(_b)``,
    ``out_norm_b``; ``params_from_jax`` of the JAX tree gives the loader's
    logits."""
    je, te = _engines(files[preset])
    jl, tl = je.params["layers"], te.params["layers"]
    assert sorted(tl[0].keys()) == sorted(jl.keys())
    want = {"wqkv_fused", "wo", "w_up", "w_down", "attn_norm", "ffn_norm"}
    if te.cfg.arch == "bloom":
        want |= {"bqkv_fused", "bo", "b_up", "b_down", "attn_norm_b", "ffn_norm_b"}
    assert set(jl) == want
    for key, jv in jl.items():
        for i, layer in enumerate(tl):
            tv = layer[key]
            for name in (("q", "s", "m", "sd", "md") if hasattr(jv, "fmt") else (None,)):
                if name and getattr(jv, name) is None:
                    assert getattr(tv, name) is None
                    continue
                a = np.asarray(getattr(jv, name) if name else jv)
                b = getattr(tv, name) if name else tv
                assert a[i].tobytes() == b.numpy().tobytes(), (key, name, i)
    top = {k for k in je.params if k != "layers"}
    assert top == set(te.params.keys()) - {"layers"}
    if te.cfg.arch == "bloom":
        assert {"tok_norm", "tok_norm_b", "out_norm_b"} <= top
    for k in top - {"lm_head"}:
        assert np.asarray(je.params[k]).tobytes() == te.params[k].numpy().tobytes(), k
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, je.params), te.cfg)
    toks = torch.tensor([[0, 5, 77, 300, 12, 9]])
    outs = []
    for p in (params, te.params):
        kv = KVCache.create(te.cfg, 1, 16, torch.float32)
        outs.append(forward(p, te.cfg, toks, kv)[0].numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("preset", PRESETS)
def test_forward_matches_jax(files, preset):
    """``forward`` against the JAX forward at f32: a 40-token prompt (K3's
    ALiBi mode: G·T = 40), then 3 decode steps fed the JAX greedy token;
    within 2e-2 of max |jax| and the same argmax."""
    je, te = _engines(files[preset])
    rng = np.random.default_rng(1)
    prompt = rng.integers(3, te.cfg.n_vocab, (1, 40))
    jkv = JKV.create(je.cfg, batch=1, max_seq=64, dtype=jnp.float32)
    kv = KVCache.create(te.cfg, 1, 64, torch.float32)
    jl, jkv = j_forward(je.params, je.cfg, jnp.asarray(prompt, jnp.int32), jkv)
    tl, kv = forward(te.params, te.cfg, torch.from_numpy(prompt), kv)
    for _ in range(4):
        a, b = np.asarray(jl[0, -1], np.float32), tl[0, -1].float().numpy()
        assert _rel(b, a) < 2e-2
        assert int(np.argmax(b)) == int(np.argmax(a))
        tok = int(np.argmax(a))
        jl, jkv = j_forward(je.params, je.cfg, jnp.asarray([[tok]], jnp.int32), jkv)
        tl, kv = forward(te.params, te.cfg, torch.tensor([[tok]]), kv)


@pytest.mark.parametrize("preset", ["tiny-mpt", "tiny-bloom"])
def test_engine_greedy_matches_jax(files, preset):
    """``Engine`` against the JAX ``Engine`` at f32: prefill and 12 decode
    steps within 1e-2, greedy tokens equal where the JAX margin is clear;
    then the fused loop (its CPU form) gives ``generate``'s tokens."""
    je, te = _engines(files[preset])
    ids = je.tokenizer.tokenize("tok5 tok77 the quick brown fox jumps over tok300",
                                add_special=True, parse_special=True)
    je.reset()
    te.reset()
    a, b = je.prefill(ids), te.prefill(ids)
    assert _rel(b, a) < 1e-2
    tok = int(np.argmax(a))
    for _ in range(12):
        a, b = je.decode_one(tok), te.decode_one(tok)
        err = _rel(b, a)
        assert err < 1e-2
        top2 = np.sort(a)[-2:]
        if top2[1] - top2[0] > 2 * err * np.abs(a).max():
            assert int(np.argmax(b)) == int(np.argmax(a))
        tok = int(np.argmax(a))
    prompt = "the quick brown fox"
    want = te.generate(prompt, n_predict=10, stop_on_eog=False)[1]
    assert te.generate_fused(prompt, n_predict=10, stop_on_eog=False, chunk=4)[1] == want


@functools.lru_cache(maxsize=None)
def _dense(path):
    """(JAX cfg, params, tokenizer) and the port's (cfg, params) of ``path``,
    every weight dequantized to f32 on both sides."""
    reader = JReader(path)
    jcfg = j_config_from_gguf(reader)
    tr = GGUFReader(path)
    cfg = config_from_gguf(tr)
    return ((jcfg, j_load_dense(reader, jcfg, jnp.float32), j_tokenizer(reader)),
            (cfg, load_llama_params(tr, cfg, torch.float32)))


@pytest.mark.parametrize("kv_dtype", [None, "q8"])
def test_batched_engine_context_shift_matches_jax(files, kv_dtype):
    """``BatchedEngine`` on tiny-mpt (f32 dense weights on both sides) at 2
    slots of 32 rows: two prompts of 24 and 9 tokens, 20 new tokens each,
    so the first slot shifts its context (rows slide, K stays unrotated:
    no rope) while the other decodes beside it; the same greedy tokens,
    shifts and fill levels as the JAX ``BatchedEngine``, the batched step
    running K3's ALiBi mode (its plain version here) at B = 2."""
    (jcfg, jparams, jtok), (cfg, params) = _dense(files["tiny-mpt"])
    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, cfg.n_vocab, 24).tolist(), rng.integers(3, cfg.n_vocab,
                                                                       9).tolist()]
    engines = (JBatched(jcfg, jparams, jtok, n_slots=2, max_seq=32, dtype=jnp.float32,
                        kv_cache_dtype=kv_dtype),
               BatchedEngine(cfg, params, _engines(files["tiny-mpt"])[1].tokenizer,
                             n_slots=2, max_seq=32, dtype=torch.float32,
                             kv_cache_dtype=kv_dtype, device="cpu"))
    outs = []
    for eng, sc in zip(engines, (JSampler, SamplerConfig)):
        slots = [eng.add_request(p, n_predict=20, sampler=sc(temp=0.0)) for p in prompts]
        toks = {s.id: [] for s in slots}
        for _ in range(80):
            for s, t, _ in eng.step():
                toks[s.id].append(t)
            if all(s.stop_reason is not None for s in slots):
                break
        outs.append([(toks[s.id], s.n_shifted, s.n_past) for s in slots])
    assert outs[0][0][1] > 0 and len(outs[0][0][0]) == 20
    assert outs[1] == outs[0]


# ---------------------------------------------------------------------------
# the decode gates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", PRESETS)
def test_decode_gates_refuse_alibi_as_jax(files, preset):
    """K6's and K7's gates refuse the ALiBi stacks as JAX's do (its graph
    clauses: LayerNorm, no rope, ALiBi, an ungated FFN), and so does the
    route; so do they a llama stack whose config alone says ALiBi."""
    je, te = _engines(files[preset])
    jkv = JKV.create(je.cfg, batch=1, max_seq=256, dtype=jnp.bfloat16)
    kv = KVCache.create(te.cfg, 1, 256, torch.bfloat16)
    want = (jk6._stream_ok(je.params, je.cfg, jkv, 1, 1),
            j_fused_ok(je.params, je.cfg, jkv, 1, 1))
    got = (k6._stream_ok(te.params, te.cfg, kv, 1, 1),
           k7._fused_ok(te.params, te.cfg, kv, 1, 1))
    assert got == want == (False, False)
    assert decode_route(te.params, te.cfg, kv) is None


@pytest.mark.parametrize("field,value", [("alibi", True), ("norm_type", "layer"),
                                         ("pos_emb", "none"), ("ffn_gated", False)])
def test_k6_gate_graph_clauses_match_jax(tmp_path, field, value):
    """On the ``small`` llama stack that both K6 gates take, each of the
    ALiBi families' graph flags alone makes both refuse it."""
    path = write_synth(str(tmp_path / "small.gguf"), "small", seed=0)
    je, te = (JEngine.from_gguf(path, max_seq=256, dtype=jnp.bfloat16),
              Engine.from_gguf(path, max_seq=256, dtype=torch.bfloat16, device="cpu"))
    jkv = JKV.create(je.cfg, batch=1, max_seq=256, dtype=jnp.bfloat16)
    kv = KVCache.create(te.cfg, 1, 256, torch.bfloat16)
    assert jk6._stream_ok(je.params, je.cfg, jkv, 1, 1)
    assert k6._stream_ok(te.params, te.cfg, kv, 1, 1)
    jcfg = dataclasses.replace(je.cfg, **{field: value})
    cfg = dataclasses.replace(te.cfg, **{field: value})
    assert not jk6._stream_ok(je.params, jcfg, jkv, 1, 1)
    assert not k6._stream_ok(te.params, cfg, kv, 1, 1)


# ---------------------------------------------------------------------------
# the JAX package's HF-built fixtures through the port's loader
# ---------------------------------------------------------------------------

HF_VOCAB = 300


def spm_vocab():
    """A vocab the port's tokenizer takes (SPM, byte tokens), for the
    converter: the JAX tests' ``gpt2`` vocab is one the port refuses."""
    tokens = ["<s>", "</s>", "<unk>"] + [f"<0x{b:02X}>" for b in range(256)]
    tokens += [f"tok{i}" for i in range(HF_VOCAB - len(tokens))]
    return {"model": "llama", "tokens": tokens, "scores": [0.0] * HF_VOCAB,
            "token_types": [3, 3, 2] + [6] * 256 + [1] * (HF_VOCAB - 259),
            "bos": 0, "eos": 1}


@pytest.mark.parametrize("arch", ["mpt", "bloom"])
def test_hf_fixture_matches_jax(tmp_path, arch):
    """tests/test_wave4_archs.py's MPT and BLOOM models (random HF weights,
    converted by the JAX converter at F32): the port's ``load_model`` and
    ``forward`` against the JAX forward, prefill and one decode step, at
    3e-3 (the JAX test's bound against HF)."""
    hf_torch = pytest.importorskip("transformers")
    from llama_cpp_gfx906_tpu.gguf import GGMLType as JGGMLType
    from llama_cpp_gfx906_tpu.tools import convert_hf

    torch.manual_seed(32 if arch == "mpt" else 33)
    if arch == "mpt":
        hf = hf_torch.MptForCausalLM(hf_torch.MptConfig(
            vocab_size=HF_VOCAB, d_model=32, n_heads=4, n_layers=2, expansion_ratio=2,
            max_seq_len=64)).eval()
    else:
        hf = hf_torch.BloomForCausalLM(hf_torch.BloomConfig(
            vocab_size=HF_VOCAB, hidden_size=32, n_head=4, n_layer=2)).eval()
    path = str(tmp_path / f"hf-{arch}.gguf")
    getattr(convert_hf, f"convert_hf_{arch}")(hf, spm_vocab(), path,
                                               quant_type=JGGMLType.F32)
    cfg, params, _ = load_model(path, torch.float32, torch.device("cpu"))
    je = JEngine.from_gguf(path, max_seq=64, dtype=jnp.float32)
    ids = [3, 17, 42, 9, 88]
    jkv = JKV.create(je.cfg, batch=1, max_seq=64, dtype=jnp.float32)
    kv = KVCache.create(cfg, 1, 64, torch.float32)
    jl, jkv = j_forward(je.params, je.cfg, jnp.asarray([ids], jnp.int32), jkv)
    tl, kv = forward(params, cfg, torch.tensor([ids]), kv)
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl[0]), rtol=3e-3, atol=3e-3)
    tok = int(np.argmax(np.asarray(jl[0, -1])))
    jl, _ = j_forward(je.params, je.cfg, jnp.asarray([[tok]], jnp.int32), jkv)
    tl, _ = forward(params, cfg, torch.tensor([[tok]]), kv)
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl[0]), rtol=3e-3, atol=3e-3)


def test_device_counts_name_the_new_k3_modes():
    """K3's ALiBi and positions modes count in device slots of their own
    (bits 2 and 3 beside int8 and shared), named in ``device_counts`` and
    so in the server's ``/metrics``; a library not loaded counts 0."""
    from llama_cpp_gfx906_tpu_torch import kernels

    counts = kernels.device_counts()
    for mode in ("alibi", "pos", "int8_alibi", "shared_alibi", "int8_pos", "alibi_pos"):
        assert counts[f"flash_decode_{mode}"] == 0
    assert kernels._SLOTS["flash_decode", 4] == ("flash_decode", "flash_decode_alibi")
    assert kernels._SLOTS["flash_decode", 8] == ("flash_decode", "flash_decode_pos")
    assert max(s for _, s in kernels._SLOTS) < kernels.COUNT_SLOTS
