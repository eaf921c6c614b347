"""gpt-oss in the port (llama_cpp_gfx906_tpu_torch) against the JAX package,
on the CPU, on the ``tiny-gpt-oss`` preset of ``tools/synth_gguf.py`` (4
layers, hidden 320, 4 / 2 heads of 64, sinks, window 16 on the even layers,
q/k/v/o biases, 4 Q4_0 experts of 512 with biases, 2 per token; its gate
and up experts pack split-K nib4, its down experts nib4c): the config and
YaRN frequencies, the loader's planes and ``params_from_jax``, ``moe_ffn``
on both of its paths, the forward, both engines, the fused loop's CPU form
and the decode gates.

Tolerances: config fields, frequencies, planes and greedy tokens exact;
``moe_ffn`` 1e-5 of max |jax| at f32 (the same f32 math from the same
planes, the all-experts path's weights dequantized to bf16 on both sides)
and 2e-2 at bf16 (as the JAX kernel tests); the forward's logits 2e-2 with
the same argmax; engine logits 1e-2 (the JAX CPU path decodes with
bf16-dequantized dense weights, the port's GEMV plain version in f32).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_cpp_gfx906_tpu.gguf import GGUFReader as JReader
from llama_cpp_gfx906_tpu.gguf.constants import RopeScalingType as JRope
from llama_cpp_gfx906_tpu.models.config import ModelConfig as JConfig
from llama_cpp_gfx906_tpu.models.config import config_from_gguf as j_config_from_gguf
from llama_cpp_gfx906_tpu.models.llama import KVCache as JKV
from llama_cpp_gfx906_tpu.models.llama import forward as j_forward
from llama_cpp_gfx906_tpu.ops import decode_stream as jk6
from llama_cpp_gfx906_tpu.ops import moe as jmoe
from llama_cpp_gfx906_tpu.ops.decode_step import _fused_ok as j_fused_ok
from llama_cpp_gfx906_tpu.ops.rope import rope_frequencies as j_rope_frequencies
from llama_cpp_gfx906_tpu.runtime.engine import Engine as JEngine
from llama_cpp_gfx906_tpu_torch.gguf.constants import RopeScalingType
from llama_cpp_gfx906_tpu_torch.gguf.reader import GGUFReader
from llama_cpp_gfx906_tpu_torch.models.config import ModelConfig, config_from_gguf
from llama_cpp_gfx906_tpu_torch.models.llama import KVCache, decode_route, forward
from llama_cpp_gfx906_tpu_torch.ops import decode_step as k7
from llama_cpp_gfx906_tpu_torch.ops import decode_stream as k6
from llama_cpp_gfx906_tpu_torch.ops import moe as tmoe
from llama_cpp_gfx906_tpu_torch.ops.rope import rope_frequencies
from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
from llama_cpp_gfx906_tpu_torch.runtime.weights import params_from_jax
from llama_cpp_gfx906_tpu_torch.tools.kernel_times import RouteLog
from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

PRESET = "tiny-gpt-oss"
FIELDS = [f.name for f in dataclasses.fields(ModelConfig)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return write_synth(str(tmp_path_factory.mktemp("oss") / f"{PRESET}.gguf"), PRESET, seed=0)


@functools.lru_cache(maxsize=None)
def _engines(path, dtype="float32"):
    """The JAX and the port's engines on ``path``."""
    return (JEngine.from_gguf(path, max_seq=128, dtype=getattr(jnp, dtype)),
            Engine.from_gguf(path, max_seq=128, dtype=getattr(torch, dtype), device="cpu"))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_config_matches_jax(path):
    """Every field of the port's config equals the JAX config's (JAX
    ``models/config.py:321-329``): NEOX rope, swa pattern 2 with layer 0
    windowed, softmax over the top-k logits, swiglu_oai with limit 7, the
    YaRN keys, the window and the expert FF."""
    jcfg = j_config_from_gguf(JReader(path))
    cfg = config_from_gguf(GGUFReader(path))
    for f in FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert (cfg.arch, cfg.act_fn, cfg.moe_topk_softmax, cfg.swiglu_limit) == (
        "gpt-oss", "swiglu_oai", True, 7.0)
    assert cfg.swa_layers == jcfg.swa_layers == (True, False, True, False)
    assert cfg.layer_windows == (16, 0, 16, 0)
    assert (cfg.rope_scaling, cfg.rope_scale, cfg.rope_orig_ctx, cfg.expert_ff) == (
        RopeScalingType.YARN, 32.0, 4096, 512)


@pytest.mark.parametrize("head_dim,base", [(64, 150000.0), (128, 10000.0)])
def test_yarn_frequencies_match_jax(head_dim, base):
    """The YaRN branch at gpt-oss's factor 32 over 4096 (a llama3-style band
    interpolation with no attention factor, as in JAX) equals JAX's."""
    kw = dict(arch="gpt-oss", n_layers=1, n_embd=2880, n_heads=64, n_kv_heads=8,
              head_dim=head_dim, n_ff=2880, n_vocab=32, n_ctx_train=131072,
              rope_base=base, rope_scaling=RopeScalingType.YARN, rope_scale=32.0,
              rope_orig_ctx=4096)
    got = rope_frequencies(ModelConfig(**kw))
    jkw = dict(kw, rope_scaling=JRope.YARN)
    want = j_rope_frequencies(JConfig(**jkw))
    assert got.dtype == np.float32 and got.tobytes() == np.asarray(want).tobytes()
    plain = rope_frequencies(dataclasses.replace(ModelConfig(**kw),
                                                 rope_scaling=RopeScalingType.NONE))
    assert (got < plain).any() and (got == plain).any()  # low bands scaled, high kept


def test_loader_matches_jax(path):
    """Byte-equal planes and vectors as the JAX loader's: biased q|k|v fused
    (int8 with mins at K 320: no nib4c chunk), ``bo``, ``sinks``, the router
    and its bias, nib4 gate/up and nib4c down experts with their biases,
    the FFN pre-norm from ``post_attention_norm``; ``params_from_jax`` of
    the JAX tree gives the loader's logits."""
    je, te = _engines(path)
    jl, tl = je.params["layers"], te.params["layers"]
    assert sorted(tl[0].keys()) == sorted(jl.keys())
    assert {"sinks", "bo", "bqkv_fused", "moe_gate_inp_b", "moe_gate_b", "moe_up_b",
            "moe_down_b", "ffn_norm"} <= set(jl)
    assert [tl[0][k].fmt for k in ("wqkv_fused", "moe_gate", "moe_up", "moe_down")] == [
        "int8", "nib4", "nib4", "nib4c"]
    for key, jv in jl.items():
        for i, layer in enumerate(tl):
            tv = layer[key]
            for name in (("q", "s", "m", "sd", "md") if hasattr(jv, "fmt") else (None,)):
                if name and getattr(jv, name) is None:
                    assert getattr(tv, name) is None
                    continue
                a = np.asarray(getattr(jv, name) if name else jv)
                b = getattr(tv, name) if name else tv
                if key == "moe_gate_inp":  # the port's router is f32 (same values)
                    b = b.to(torch.float32)
                assert a[i].tobytes() == b.numpy().tobytes(), (key, name, i)
    assert np.array_equal(np.asarray(jl["ffn_norm"]), np.asarray(jl["post_attn_norm"]))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, je.params), te.cfg)
    toks = torch.tensor([[0, 5, 77, 300, 12, 9, 41, 1000, 3, 3, 17, 2000, 8, 64, 5, 6, 7, 9,
                          11, 13]])
    outs = []
    for p in (params, te.params):
        kv = KVCache.create(te.cfg, 1, 32, torch.float32)
        outs.append(forward(p, te.cfg, toks, kv)[0].numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 3, 8, 20])
def test_moe_ffn_matches_jax(path, dtype, T):
    """``moe_ffn`` of layer 1 (router bias, top-2 softmax, expert biases,
    swiglu_oai) against the JAX function: the routed path up to 8 tokens
    (nib4 gate/up, nib4c down: the quantized gather on the CPU), every
    expert above (the dequant matmul)."""
    je, te = _engines(path, dtype)
    jp = {k: v[1] for k, v in je.params["layers"].items() if not hasattr(v, "fmt")}
    jq = {k: v for k, v in je.params["layers"].items() if hasattr(v, "fmt")}
    jq = {k: jax.tree_util.tree_map(lambda a: a[1], v) for k, v in jq.items()}
    p = te.params["layers"][1]
    x = np.random.default_rng(T).standard_normal((1, T, te.cfg.n_embd)).astype(np.float32)
    got = tmoe.moe_ffn(torch.from_numpy(x).to(getattr(torch, dtype)), p["moe_gate_inp"],
                       p["moe_gate"], p["moe_up"], p["moe_down"], te.cfg,
                       router_b=p["moe_gate_inp_b"], gate_b=p["moe_gate_b"],
                       up_b=p["moe_up_b"], down_b=p["moe_down_b"])
    ref = jmoe.moe_ffn(jnp.asarray(x, getattr(jnp, dtype)), jp["moe_gate_inp"],
                       jq["moe_gate"], jq["moe_up"], jq["moe_down"], je.cfg,
                       router_b=jp["moe_gate_inp_b"], gate_b=jp["moe_gate_b"],
                       up_b=jp["moe_up_b"], down_b=jp["moe_down_b"])
    assert got.shape == (1, T, te.cfg.n_embd) and got.dtype == getattr(torch, dtype)
    assert _rel(got, ref) < (1e-5 if dtype == "float32" else 2e-2)


def test_route_softmaxes_the_top_k_logits():
    """gpt-oss's router: the top-k logits (the first maximum on ties) and
    their softmax, as ``lax.top_k`` then ``softmax``."""
    cfg = ModelConfig(arch="gpt-oss", n_layers=1, n_embd=8, n_heads=1, n_kv_heads=1,
                      head_dim=8, n_ff=8, n_vocab=8, n_ctx_train=8, n_experts=6,
                      n_experts_used=3, moe_topk_softmax=True)
    logits = torch.tensor([[0.5, 2.0, 2.0, -1.0, 1.5, 0.0], [3.0, 0.1, 0.2, 0.3, 0.4, 9.0]])
    w, ids = tmoe.route(logits, cfg)
    topl, topi = jax.lax.top_k(jnp.asarray(logits.numpy()), 3)
    assert ids.tolist() == np.asarray(topi).tolist() == [[1, 2, 4], [5, 0, 4]]
    np.testing.assert_allclose(w.numpy(), np.asarray(jax.nn.softmax(topl, -1)), rtol=1e-6)


def test_forward_matches_jax(path):
    """``forward`` against the JAX forward at f32: a 40-token prompt (past
    the 16-row window of the even layers; G·T = 80: K3 on the card), then 4
    decode steps fed the JAX greedy token; within 2e-2 of max |jax| and the
    same argmax."""
    je, te = _engines(path)
    prompt = np.random.default_rng(1).integers(3, te.cfg.n_vocab, (1, 40))
    jkv = JKV.create(je.cfg, batch=1, max_seq=64, dtype=jnp.float32)
    kv = KVCache.create(te.cfg, 1, 64, torch.float32)
    jl, jkv = j_forward(je.params, je.cfg, jnp.asarray(prompt, jnp.int32), jkv)
    tl, kv = forward(te.params, te.cfg, torch.from_numpy(prompt), kv)
    for _ in range(5):
        a, b = np.asarray(jl[0, -1], np.float32), tl[0, -1].float().numpy()
        assert _rel(b, a) < 2e-2
        assert int(np.argmax(b)) == int(np.argmax(a))
        tok = int(np.argmax(a))
        jl, jkv = j_forward(je.params, je.cfg, jnp.asarray([[tok]], jnp.int32), jkv)
        tl, kv = forward(te.params, te.cfg, torch.tensor([[tok]]), kv)


def test_engine_greedy_matches_jax(path):
    """``Engine`` against the JAX ``Engine`` at f32 on a 29-token prompt
    (past the window): the prefill's and 8 decode steps' logits within
    1e-2, and the 8 greedy tokens of ``generate`` identical; the fused loop
    (its CPU form) gives the same tokens.  The comparison is meaningful
    only where no route sits at a near-tie (the JAX CPU path and the port
    round differently, ROADMAP §3), which the test checks: every top-k
    boundary gap of the port's routes is above 1e-3 (on this prompt 6.9e-3;
    see the next test for a prompt that meets one)."""
    je, te = _engines(path)
    prompt = "the quick brown fox"
    ids = je.tokenizer.tokenize(prompt, add_special=True, parse_special=True)
    assert ids == te.tokenizer.tokenize(prompt, add_special=True, parse_special=True)
    assert len(ids) > 16  # past the window
    je.reset()
    te.reset()
    with RouteLog() as routes:
        a, b = je.prefill(ids), te.prefill(ids)
        assert _rel(b, a) < 1e-2
        tok = int(np.argmax(a))
        for _ in range(8):
            a, b = je.decode_one(tok), te.decode_one(tok)
            assert _rel(b, a) < 1e-2
            tok = int(np.argmax(a))
    assert routes.margin() > 1e-3
    want = je.generate(prompt, n_predict=8, stop_on_eog=False)[1]
    assert te.generate(prompt, n_predict=8, stop_on_eog=False)[1] == want
    assert te.generate_fused(prompt, n_predict=8, stop_on_eog=False, chunk=4)[1] == want


def test_engine_gap_is_a_router_near_tie(path):
    """Where the engines part (an 84-token prompt: the sixth decode step's
    logits 0.31 apart, then other greedy tokens), the port's routing of
    that step had a near-tie, a top-k boundary gap below 1e-4 (2.3e-5 at
    layer 3), and every step before and after it agrees within 1e-2."""
    je, te = _engines(path)
    prompt = "tok5 tok77 the quick brown fox jumps over tok300 and tok1000"
    ids = je.tokenizer.tokenize(prompt, add_special=True, parse_special=True)
    je.reset()
    te.reset()
    a = je.prefill(ids)
    te.prefill(ids)
    tok, errs, step_gaps = int(np.argmax(a)), [], []
    for _ in range(8):
        with RouteLog() as routes:
            b = te.decode_one(tok)
        a = je.decode_one(tok)
        errs.append(_rel(b, a))
        step_gaps.append(routes.margin())
        tok = int(np.argmax(a))
    apart = [i for i, e in enumerate(errs) if e >= 1e-2]
    assert apart == [5] and step_gaps[5] < 1e-4
    assert all(step_gaps[i] > 1e-4 for i in range(8) if i != 5)


def test_decode_gates_refuse_gpt_oss_as_jax(path):
    """K6's and K7's gates refuse the gpt-oss stack as JAX's do (swiglu_oai,
    D = 320 and Dh = 64 off the 128 grid, sinks, biases), so the route is
    the per-layer loop; on the ``small`` llama stack that both K6 gates
    take, swiglu_oai alone makes both refuse it."""
    je, te = _engines(path, "bfloat16")
    jkv = JKV.create(je.cfg, batch=1, max_seq=128, dtype=jnp.bfloat16)
    kv = KVCache.create(te.cfg, 1, 128, torch.bfloat16)
    want = (jk6._stream_ok(je.params, je.cfg, jkv, 1, 1),
            j_fused_ok(je.params, je.cfg, jkv, 1, 1))
    got = (k6._stream_ok(te.params, te.cfg, kv, 1, 1),
           k7._fused_ok(te.params, te.cfg, kv, 1, 1))
    assert got == want == (False, False)
    assert decode_route(te.params, te.cfg, kv) is None
    small = write_synth(path.replace(PRESET, "small"), "small", seed=0)
    je, te = (JEngine.from_gguf(small, max_seq=256, dtype=jnp.bfloat16),
              Engine.from_gguf(small, max_seq=256, dtype=torch.bfloat16, device="cpu"))
    jkv = JKV.create(je.cfg, batch=1, max_seq=256, dtype=jnp.bfloat16)
    kv = KVCache.create(te.cfg, 1, 256, torch.bfloat16)
    assert jk6._stream_ok(je.params, je.cfg, jkv, 1, 1)
    assert k6._stream_ok(te.params, te.cfg, kv, 1, 1)
    jcfg = dataclasses.replace(je.cfg, act_fn="swiglu_oai")
    cfg = dataclasses.replace(te.cfg, act_fn="swiglu_oai")
    assert not jk6._stream_ok(je.params, jcfg, jkv, 1, 1)
    assert not k6._stream_ok(te.params, cfg, kv, 1, 1)
