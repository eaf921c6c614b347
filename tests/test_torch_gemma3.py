"""Gemma 3 in the port (llama_cpp_gfx906_tpu_torch) against the JAX package,
on the CPU.

The whole slice on ``tiny-gemma3`` (Q4_K_M mix) and ``tiny-gemma3-q8_0``
(``tools/synth_gguf.py``: 6 layers, five of them windowed to 16 tokens,
random norm vectors, a tied head): the config, the loader, the per-layer
forward, the engines, the batched engine and the server.  The gemma modes of
the decode kernels K6 and K7: their plain versions against the JAX kernels
in interpret mode, and their gates against the JAX gates, on the JAX kernel
tests' small stack (tests/test_decode_stream.py:163,
tests/test_decode_step.py:119: L 3, D 256, Dh 128, random norms).

Tolerances, each the one the JAX package's own test of the same thing uses:
logits 2e-2 (``assert_allclose`` rtol = atol) and equal argmax for the
forward and the decode kernels, the KV rows 3e-2; engine logits at f32 1e-2
(max |port - jax| / max |jax|, as tests/test_torch_engine.py); greedy tokens
exactly.
"""

import dataclasses
import functools
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_cpp_gfx906_tpu.gguf import GGMLType as JGGMLType
from llama_cpp_gfx906_tpu.gguf import GGUFReader as JReader
from llama_cpp_gfx906_tpu.gguf import quantize
from llama_cpp_gfx906_tpu.gguf.constants import RopeScalingType as JRope
from llama_cpp_gfx906_tpu.models.config import ModelConfig as JConfig
from llama_cpp_gfx906_tpu.models.config import config_from_gguf as j_config_from_gguf
from llama_cpp_gfx906_tpu.models.llama import KVCache as JKV
from llama_cpp_gfx906_tpu.models.llama import forward as j_forward
from llama_cpp_gfx906_tpu.ops import decode_stream as jk6
from llama_cpp_gfx906_tpu.ops import quant_matmul as jqmm
from llama_cpp_gfx906_tpu.ops.decode_step import _fused_ok as j_fused_ok
from llama_cpp_gfx906_tpu.ops.decode_step import fused_decode_step as j_k7
from llama_cpp_gfx906_tpu.ops.norms import rms_norm as j_rms_norm
from llama_cpp_gfx906_tpu.ops.rope import rope_frequencies as j_rope_frequencies
from llama_cpp_gfx906_tpu.runtime.batch_engine import BatchedEngine as JBatched
from llama_cpp_gfx906_tpu.runtime.batch_engine import SamplerConfig as JSampler
from llama_cpp_gfx906_tpu.runtime.engine import Engine as JEngine
from llama_cpp_gfx906_tpu.runtime.weights import fuse_projections as j_fuse
from llama_cpp_gfx906_tpu_torch.gguf.constants import GGMLType, RopeScalingType
from llama_cpp_gfx906_tpu_torch.gguf.reader import GGUFReader
from llama_cpp_gfx906_tpu_torch.models.config import ModelConfig, config_from_gguf
from llama_cpp_gfx906_tpu_torch.models.llama import KVCache, forward
from llama_cpp_gfx906_tpu_torch.ops import decode_step as k7
from llama_cpp_gfx906_tpu_torch.ops import decode_stream as k6
from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as tqmm
from llama_cpp_gfx906_tpu_torch.ops.norms import rms_norm
from llama_cpp_gfx906_tpu_torch.ops.quant_matmul import linear
from llama_cpp_gfx906_tpu_torch.ops.rope import layer_inv_freqs
from llama_cpp_gfx906_tpu_torch.runtime.batch_engine import BatchedEngine, SamplerConfig
from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
from llama_cpp_gfx906_tpu_torch.runtime.weights import params_from_jax
from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

PRESETS = ("tiny-gemma3", "tiny-gemma3-q8_0")
GEMMA_FIELDS = ("arch", "n_layers", "n_embd", "n_heads", "n_kv_heads", "head_dim", "n_ff",
                "n_vocab", "rms_eps", "rope_base", "rope_scale", "rope_interleaved",
                "sliding_window", "swa_pattern", "attn_scale", "rope_local_base", "qk_norm",
                "post_attn_norm", "post_ffn_norm", "embedding_scale", "act_fn",
                "attn_logit_softcap", "swa_layers")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gemma3")
    return {p: write_synth(str(d / f"{p}.gguf"), p, seed=0) for p in PRESETS}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def port_cfg(jcfg) -> ModelConfig:
    names = [f.name for f in dataclasses.fields(ModelConfig) if f.name != "rope_scaling"]
    return ModelConfig(**{n: getattr(jcfg, n) for n in names},
                       rope_scaling=RopeScalingType(int(jcfg.rope_scaling)))


# ---------------------------------------------------------------------------
# config and rope
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", PRESETS)
def test_config_matches_jax(files, preset):
    """Every gemma field, the per-layer SWA flags and the per-layer rope
    frequencies (SWA layers: the local base, unscaled) as JAX's."""
    jcfg = j_config_from_gguf(JReader(files[preset]))
    cfg = config_from_gguf(GGUFReader(files[preset]))
    for f in GEMMA_FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert int(cfg.rope_scaling) == int(jcfg.rope_scaling)
    assert cfg.swa_layers == (True,) * 5 + (False,)
    assert cfg.act_fn == "gelu" and cfg.rms_eps == pytest.approx(1e-6)
    assert cfg.embedding_scale == pytest.approx(cfg.n_embd ** 0.5)
    glob = j_rope_frequencies(jcfg)
    loc = j_rope_frequencies(jcfg.with_(rope_base=jcfg.rope_local_base,
                                        rope_scaling=JRope.NONE))
    for swa, inv in zip(cfg.swa_layers, layer_inv_freqs(cfg, "cpu")):
        np.testing.assert_allclose(inv.numpy(), loc if swa else glob, rtol=1e-7, atol=0)
    if preset == "tiny-gemma3":  # linear scaling 8 on the global layer only
        assert cfg.rope_scale == 8.0 and not np.allclose(glob * 8, loc)


@pytest.mark.parametrize("arch", ["gemma", "gemma2"])
def test_config_refuses_gemma_v1_and_v2(arch):
    class Reader:
        architecture = arch

    with pytest.raises(NotImplementedError, match="Gemma"):
        config_from_gguf(Reader())


def test_chunk_grid_matches_jax():
    """The pure functions that decide whether a Q4_K_M gemma reaches K6, at
    the hidden widths of Gemma-3-4B, 12B, 27B and 1B: the nib4c chunk, K6's
    K chunk and the per-model scale fold."""
    for K in (2560, 3840, 5376, 1152, 10240, 2048):
        assert tqmm.nib4c_chunk(K) == jqmm.nib4c_chunk(K)
        for g in (16, 32):
            assert k6._proj_tk(K, g, True) == jk6._proj_tk(K, g, True)
            assert k6._proj_tk(K, g, False) == jk6._proj_tk(K, g, False)
        for jt, t in ((JGGMLType.Q4_K, GGMLType.Q4_K), (JGGMLType.Q6_K, GGMLType.Q6_K)):
            assert tqmm._fold_streams(K, t) == jqmm._fold_streams(K, jt)
    assert k6._proj_tk(2560, 32, True) == 512 and not tqmm._fold_streams(2560, GGMLType.Q4_K)
    assert k6._proj_tk(3840, 32, True) is None and k6._proj_tk(5376, 32, True) is None
    assert tqmm.nib4c_chunk(1152) is None


# ---------------------------------------------------------------------------
# the loader, the forward and the engines on the synthetic files
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _engines(path):
    """The JAX and the port's engines on ``path`` at f32 (the JAX engine
    pads a prefill to a bucket of 128 rows)."""
    return (JEngine.from_gguf(path, max_seq=256, dtype=jnp.float32),
            Engine.from_gguf(path, max_seq=256, dtype=torch.float32, device="cpu"))


@pytest.mark.parametrize("preset", PRESETS)
def test_loader_matches_jax(files, preset):
    """Byte-equal planes, equal norm vectors (the four gemma ones among
    them) and the tied head (no output.weight: tok_emb.T) as the JAX
    loader's; ``params_from_jax`` of the JAX tree gives the loader's logits."""
    je, te = _engines(files[preset])
    jl, tl = je.params["layers"], te.params["layers"]
    assert sorted(tl[0].keys()) == sorted(jl.keys())
    assert {"q_norm", "k_norm", "post_attn_norm", "post_ffn_norm"} <= set(jl)
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
    for key in ("tok_emb", "lm_head", "out_norm"):
        np.testing.assert_array_equal(te.params[key].float().numpy(),
                                      np.asarray(je.params[key], np.float32))
    assert te.params["lm_head"].shape == (te.cfg.n_embd, te.cfg.n_vocab)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, je.params), te.cfg)
    toks = torch.tensor([[0, 5, 77, 300, 12, 9]])
    outs = []
    for p in (params, te.params):
        kv = KVCache.create(te.cfg, 1, 16, torch.float32)
        outs.append(forward(p, te.cfg, toks, kv)[0].numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


def test_layer_table_gemma_words(files):
    """The decode kernels' plane table of a gemma3 stack: each layer's
    window (0 on the global layer), then, after the MoE words, the four
    gemma norm vectors and the SWA flag."""
    from llama_cpp_gfx906_tpu_torch.runtime.weights import layer_table

    te = _engines(files["tiny-gemma3"])[1]
    table = layer_table(te.params, te.cfg)
    assert table.shape == (6, k6.TABLE_W) == (6, 50)
    for li, p in enumerate(te.params["layers"]):
        row = table[li].tolist()
        assert row[25:28] == [p["attn_norm"].data_ptr(), p["ffn_norm"].data_ptr(),
                              16 if li < 5 else 0]
        assert row[28:44] == [0] * 16
        assert row[44:49] == [p[k].data_ptr() for k in k6.GEMMA_NORMS] + [int(li < 5)]
        assert row[49] == 0  # no shared expert


@pytest.mark.parametrize("preset", PRESETS)
def test_forward_matches_jax(files, preset):
    """``forward`` (the per-layer loop on the CPU) against the JAX forward
    (its scan) at f32 on the same file: a 40-token prompt, past the 16-token
    window, then 3 decode steps, each fed the JAX greedy token; max |port -
    jax| / max |jax| within 2e-2 and the same argmax.  (At f32 the prefill
    agrees to ~2e-6 and the decode steps to ~6e-3, the JAX CPU path's bf16
    dequantized decode weights; in bf16 the two packages' rounding walks
    part by ~2.5% of these logits, whose scale is ~6.)"""
    je, te = _engines(files[preset])
    cfg, jcfg = te.cfg, je.cfg
    rng = np.random.default_rng(1)
    prompt = rng.integers(3, cfg.n_vocab - 2, (1, 40))
    jkv = JKV.create(jcfg, batch=1, max_seq=64, dtype=jnp.float32)
    kv = KVCache.create(cfg, 1, 64, torch.float32)
    jl, jkv = j_forward(je.params, jcfg, jnp.asarray(prompt, jnp.int32), jkv)
    tl, kv = forward(te.params, cfg, torch.from_numpy(prompt), kv)
    for _ in range(4):
        a, b = np.asarray(jl[0, -1], np.float32), tl[0, -1].float().numpy()
        assert _rel(b, a) < 2e-2
        assert int(np.argmax(b)) == int(np.argmax(a))
        tok = int(np.argmax(a))
        jl, jkv = j_forward(je.params, jcfg, jnp.asarray([[tok]], jnp.int32), jkv)
        tl, kv = forward(te.params, cfg, torch.tensor([[tok]]), kv)


@pytest.mark.parametrize("preset", PRESETS)
def test_engine_greedy_matches_jax(files, preset):
    """``Engine`` against the JAX ``Engine`` at f32: prefill and 8 decode
    steps' logits within 1e-2, and ``generate``'s greedy tokens exactly."""
    je, te = _engines(files[preset])
    ids = je.tokenizer.tokenize("tok5 tok77 the quick brown fox jumps over tok300",
                                add_special=True, parse_special=True)
    assert len(ids) > 16  # past the window
    je.reset()
    te.reset()
    a, b = je.prefill(ids), te.prefill(ids)
    assert _rel(b, a) < 1e-2
    tok = int(np.argmax(a))
    for _ in range(8):
        a, b = je.decode_one(tok), te.decode_one(tok)
        assert _rel(b, a) < 1e-2
        tok = int(np.argmax(a))
    prompt = "<start_of_turn>user\nhello tok9<end_of_turn>\n<start_of_turn>model\n"
    jt = je.generate(prompt, n_predict=12, stop_on_eog=False)[1]
    tt = te.generate(prompt, n_predict=12, stop_on_eog=False)[1]
    assert tt == jt


def test_batched_engine_matches_single_stream(files):
    """``BatchedEngine`` at 2 slots (prefill chunks of 8, past the window,
    then the batched decode step) gives each prompt the single-stream
    greedy tokens."""
    path = files["tiny-gemma3"]
    single = _engines(path)[1]
    be = BatchedEngine.from_gguf(path, dtype=torch.float32, device="cpu", n_slots=2,
                                 max_seq=64, n_chunk=8)
    prompts = ["the quick brown fox jumps over the lazy dog", "tok5 tok7 jumps over tok9"]
    want = [single.generate(p, n_predict=8, stop_on_eog=False)[1] for p in prompts]
    slots = [be.add_request(be.tokenizer.tokenize(p, add_special=True, parse_special=True),
                            8, SamplerConfig(temp=0.0)) for p in prompts]
    got = {s.id: [] for s in slots}
    while any(s.stop_reason is None for s in slots):
        for s, t, _ in be.step():
            got[s.id].append(t)
    assert [got[s.id] for s in slots] == want


def test_q8_context_shift_matches_jax(files):
    """A q8 slot of tiny-gemma3-q8_0 reaches max_seq and shifts its context
    as the JAX engine does: both re-rope the moved K rows with the global
    frequencies on every layer, the SWA layers' too (a reference-side fact,
    kept at parity), and go on to the same tokens."""
    path = files["tiny-gemma3-q8_0"]
    reader = JReader(path)
    jcfg = j_config_from_gguf(reader)
    je = _engines(path)[0]
    prompt = je.tokenizer.tokenize("The quick brown fox jumps over it tok5 tok9",
                                   add_special=True, parse_special=True)[:24]
    outs = []
    for eng, sc in ((JBatched(jcfg, je.params, je.tokenizer, dtype=jnp.float32, n_slots=2,
                              max_seq=32, kv_cache_dtype="q8"), JSampler),
                    (BatchedEngine.from_gguf(path, dtype=torch.float32, device="cpu",
                                             n_slots=2, max_seq=32, kv_cache_dtype="q8"),
                     SamplerConfig)):
        slot = eng.add_request(prompt, n_predict=20, sampler=sc(temp=0.0))
        toks = []
        for _ in range(80):
            toks += [t for s, t, _ in eng.step() if s is slot]
            if slot.stop_reason is not None:
                break
        outs.append((toks, slot.n_shifted, slot.n_past))
    assert outs[0][1] > 0 and len(outs[0][0]) == 20
    assert outs[1] == outs[0]


def test_server_chat_completion_gemma_template(files):
    """The HTTP server on tiny-gemma3-q8_0 answers a chat completion; the
    file's template renders with Gemma's turn markers (``gemma``)."""
    from llama_cpp_gfx906_tpu_torch.chat import render_chat_template
    from llama_cpp_gfx906_tpu_torch.chat.templates import detect_template
    from llama_cpp_gfx906_tpu_torch.server.app import InferenceServer, make_server

    eng = BatchedEngine.from_gguf(files["tiny-gemma3-q8_0"], dtype=torch.float32,
                                  device="cpu", n_slots=2, max_seq=128, n_chunk=16)
    tmpl = eng.tokenizer.vocab.chat_template
    assert detect_template(tmpl) == "gemma"
    msgs = [{"role": "user", "content": "hi"}]
    assert render_chat_template(tmpl, msgs, add_generation_prompt=True).endswith(
        "<start_of_turn>user\nhi<end_of_turn>\n<start_of_turn>model\n")
    srv = InferenceServer(eng, model_name="tiny-gemma3")
    srv.start()
    httpd = make_server(srv, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/v1/chat/completions",
            data=json.dumps({"messages": msgs, "max_tokens": 6, "temperature": 0}).encode(),
            method="POST", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            status, out = r.status, json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
    assert status == 200 and out["object"] == "chat.completion"
    assert isinstance(out["choices"][0]["message"]["content"], str)
    assert out["usage"]["completion_tokens"] == 6


# ---------------------------------------------------------------------------
# K6 / K7 gemma modes: plain versions and gates against the JAX kernels
# ---------------------------------------------------------------------------

L, D, HQ, HKV, DH, F, V, S = 3, 256, 2, 1, 128, 512, 64, 256


def j_cfg(**kw):
    base = dict(qk_norm=True, post_attn_norm=True, post_ffn_norm=True, sliding_window=16,
                swa_pattern=2, rope_local_base=10000.0, rope_base=1000000.0)
    base.update(kw)
    return JConfig(arch="gemma3", n_layers=L, n_embd=D, n_heads=HQ, n_kv_heads=HKV,
                   head_dim=DH, n_ff=F, n_vocab=V, n_ctx_train=S, **base)


# the JAX tests' gemma config (NORM rope, silu), and gemma3's own (NEOX,
# gelu-tanh, linear scaling 8 on the global layers)
CFGS = {"jax_test": dict(rope_interleaved=True),
        "gemma3": dict(rope_interleaved=False, act_fn="gelu",
                       rope_scaling=JRope.LINEAR, rope_scale=8.0)}


def _q8(rng, K, N):
    w = rng.standard_normal((N, K), dtype=np.float32) * 0.05
    qt = jqmm.pack_gguf_tensor(quantize(w, JGGMLType.Q8_0), JGGMLType.Q8_0, (N, K))
    return jqmm.QuantTensor(q=jnp.stack([qt.q] * L), s=jnp.stack([qt.s] * L), m=None,
                            fmt=qt.fmt, group=qt.group, shape=qt.shape)


def gemma_params(seed=9):
    """The JAX gemma kernel tests' stack: Q8_0 projections, random norms."""
    rng = np.random.default_rng(seed)
    head = rng.standard_normal((V, D), dtype=np.float32) * 0.05
    layers = j_fuse({
        "attn_norm": jnp.ones((L, D), jnp.float32) * 1.1,
        "ffn_norm": jnp.ones((L, D), jnp.float32) * 0.9,
        "wq": _q8(rng, D, HQ * DH), "wk": _q8(rng, D, HKV * DH), "wv": _q8(rng, D, HKV * DH),
        "wo": _q8(rng, HQ * DH, D), "w_gate": _q8(rng, D, F), "w_up": _q8(rng, D, F),
        "w_down": _q8(rng, F, D)})
    for k, n in (("q_norm", DH), ("k_norm", DH), ("post_attn_norm", D), ("post_ffn_norm", D)):
        layers[k] = jnp.asarray(1.0 + 0.1 * rng.standard_normal((L, n)), jnp.float32)
    return {"tok_emb": jnp.asarray(rng.standard_normal((V, D)) * 0.1, jnp.bfloat16),
            "out_norm": jnp.ones(D, jnp.float32),
            "lm_head": jqmm.pack_gguf_tensor(quantize(head, JGGMLType.Q8_0), JGGMLType.Q8_0,
                                             (V, D)),
            "layers": layers}


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


@functools.lru_cache(maxsize=None)
def _j_kernel(jcfg, k7_kernel: bool):
    fn = j_k7 if k7_kernel else jk6.fused_decode_step_streamed
    return jax.jit(lambda p, x, kv: fn(p, jcfg, x, kv, interpret=True))


@pytest.mark.parametrize("kernel,lens", [("k6", (40,)), ("k6", (40, 7, 25)), ("k7", (40,))])
@pytest.mark.parametrize("which", sorted(CFGS))
def test_gemma_plain_matches_jax_kernel(kernel, lens, which):
    """Prefill each slot through the JAX forward (40 tokens: past the
    window), then 3 steps through the JAX kernel in interpret mode and the
    port's plain version from the same cache; logits 2e-2, the whole cache
    3e-2, and the same argmax in every slot whose top two logits are more
    than twice the step's largest difference apart (at B = 3 a slot can
    hold a near-tie: 2.828 against 2.844 with differences of 0.018; at
    least one slot per step is held)."""
    jcfg = j_cfg(**CFGS[which])
    cfg = port_cfg(jcfg)
    jparams = gemma_params()
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    B = len(lens)
    rng = np.random.default_rng(7)
    jkv = JKV.create(jcfg, batch=B, max_seq=S, dtype=jnp.bfloat16)
    toks = np.zeros((B, max(lens)), np.int32)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(0, V, n)
    _, jkv = j_forward(jparams, jcfg, jnp.asarray(toks), jkv,
                       n_tokens=jnp.asarray(lens, jnp.int32))
    kv = KVCache(k=_t(jkv.k), v=_t(jkv.v), n_past=torch.tensor(lens, dtype=torch.int32))
    if kernel == "k7":
        assert j_fused_ok(jparams, jcfg, jkv, B, 1) and k7._fused_ok(params, cfg, kv, B, 1)
        port = k7.fused_decode_step
    else:
        assert jk6._stream_ok(jparams, jcfg, jkv, B, 1) and k6._stream_ok(params, cfg, kv, B, 1)
        port = k6.fused_decode_step_streamed
    tok = rng.integers(0, V, (B, 1)).astype(np.int32)
    for _ in range(3):
        jx2, jk, jv = _j_kernel(jcfg, kernel == "k7")(jparams, jparams["tok_emb"][tok], jkv)
        jkv = JKV(k=jk, v=jv, n_past=jkv.n_past + 1)
        x2 = port(params, cfg, params["tok_emb"][torch.from_numpy(tok)], kv)
        kv.n_past += 1
        jl = _f32(jqmm.linear(j_rms_norm(jx2, jparams["out_norm"], jcfg.rms_eps),
                              jparams["lm_head"]))
        tl = _f32(linear(rms_norm(x2, params["out_norm"], cfg.rms_eps), params["lm_head"]))
        np.testing.assert_allclose(tl, jl, rtol=2e-2, atol=2e-2)
        err = float(np.abs(tl - jl).max())
        top2 = np.sort(jl[:, 0], -1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * err  # slots without a near-tie
        assert clear.any()
        assert (np.argmax(tl[:, 0], -1) == np.argmax(jl[:, 0], -1))[clear].all()
        np.testing.assert_allclose(_f32(kv.k), _f32(jkv.k), rtol=3e-2, atol=3e-2)
        np.testing.assert_allclose(_f32(kv.v), _f32(jkv.v), rtol=3e-2, atol=3e-2)
        tok = np.argmax(jl[:, 0], -1).reshape(B, 1).astype(np.int32)


def _without(jparams, *keys):
    return dict(jparams, layers={k: v for k, v in jparams["layers"].items() if k not in keys})


GATE_CASES = {
    "gemma": ({}, ()),
    "qk_norm_without_q_norm": ({}, ("q_norm",)),
    "q_norm_without_qk_norm": (dict(qk_norm=False), ()),
    "post_norms_unpaired_params": ({}, ("post_ffn_norm",)),
    "post_norms_unpaired_cfg": (dict(post_ffn_norm=False), ()),
    "post_norms_without_cfg": (dict(post_attn_norm=False, post_ffn_norm=False), ()),
    "swa_window_0": (dict(sliding_window=0), ()),
    "softcap": (dict(attn_logit_softcap=50.0), ()),
    "gelu_erf": (dict(act_fn="gelu_erf"), ()),
    "relu": (dict(act_fn="relu"), ()),
    "no_gemma_norms": (dict(qk_norm=False, post_attn_norm=False, post_ffn_norm=False),
                       ("q_norm", "k_norm", "post_attn_norm", "post_ffn_norm")),
    "q8_cache": ({}, ()),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gemma_gates_match_jax(case):
    """K6's and K7's gates accept and refuse as JAX's on the same params."""
    kw, drop = GATE_CASES[case]
    jcfg = j_cfg(**kw)
    cfg = port_cfg(jcfg)
    jparams = _without(gemma_params(), *drop)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    dtype = "q8" if case == "q8_cache" else jnp.bfloat16
    jkv = JKV.create(jcfg, batch=1, max_seq=S, dtype=dtype)
    kv = KVCache.create(cfg, 1, S, "q8" if case == "q8_cache" else torch.bfloat16)
    want = (j_fused_ok(jparams, jcfg, jkv, 1, 1), jk6._stream_ok(jparams, jcfg, jkv, 1, 1))
    assert (k7._fused_ok(params, cfg, kv, 1, 1), k6._stream_ok(params, cfg, kv, 1, 1)) == want
    if case in ("gemma", "swa_window_0", "gelu_erf", "no_gemma_norms"):
        assert want == (True, True)
    else:
        assert want == (False, False)


@pytest.mark.parametrize("preset,n_layers,kernel", [("tiny-gemma3", 34, "k6"),
                                                    ("gemma3-270m-q8_0", 18, "k7")])
def test_gemma_loop_gap_matches_jax_reference(tmp_path, preset, n_layers, kernel):
    """The decode kernels' gemma modes against the per-layer loop at depth,
    in both packages: 8 decode steps from one state (a 64-token prompt,
    past the window) through the kernel and through the loop (JAX: the
    kernel in interpret mode against its layer scan; the port: the plain
    version against ``layers_forward``).  K6 at Gemma-3-4B's 34 layers on
    tiny-gemma3's width, K7 on the Gemma-3-270M preset at its full width
    and 18 layers.  The fused route rounds where the JAX kernel does, the
    loop where the scan does; with random weights the two drift apart with
    depth, the JAX package's own kernels by ~3.7e-2 (K6) and ~2.7e-2 (K7)
    of the logits' scale here, beyond the checks of its shallow tests.  The
    port's gap must be no larger than 1.5x the reference's (as
    tests/test_torch_decode_step.py::test_k7_loop_gap_matches_jax_reference
    holds K7's llama mode)."""
    from llama_cpp_gfx906_tpu_torch.models.llama import embed, layers_forward

    path = write_synth(str(tmp_path / f"{preset}.gguf"), preset, seed=0, n_layers=n_layers,
                       n_vocab=512)
    je = JEngine.from_gguf(path, max_seq=256, dtype=jnp.bfloat16)
    te = Engine.from_gguf(path, max_seq=256, device="cpu")
    words = " ".join(f"w{i % 97}" for i in range(40))
    ids = te.tokenizer.tokenize(f"The synthetic model reads: {words}",
                                add_special=True, parse_special=True)[:64]
    jp, jcfg = je.params, je.cfg
    tok = int(np.argmax(je.prefill(ids)))
    kv0 = je.kv
    gate = j_fused_ok if kernel == "k7" else jk6._stream_ok
    assert gate(jp, jcfg, kv0, 1, 1)

    def j_head(x):
        return _f32(jqmm.linear(j_rms_norm(x, jp["out_norm"], jcfg.rms_eps),
                                jp["lm_head"]))[0, -1]

    def j_embed(t):
        x = jp["tok_emb"][jnp.asarray([[t]])]
        return (x.astype(jnp.float32) * jcfg.embedding_scale).astype(x.dtype)

    fed, j_fused, kv = [], [], kv0
    for _ in range(8):
        fed.append(tok)
        x2, k, v = _j_kernel(jcfg, kernel == "k7")(jp, j_embed(tok), kv)
        kv = JKV(k=k, v=v, n_past=kv.n_past + 1)
        j_fused.append(j_head(x2))
        tok = int(np.argmax(j_fused[-1]))
    j_loop, kv = [], kv0
    for t in fed:
        logits, kv = j_forward(jp, jcfg, jnp.asarray([[t]], jnp.int32), kv)
        j_loop.append(_f32(logits)[0, -1])

    def t_run(layers_fn):
        te.reset()
        te.prefill(ids)
        p, out = te.params, []
        with torch.inference_mode():
            for t in fed:
                x = layers_fn(p, te.cfg, embed(p, te.cfg, torch.tensor([[t]])), te.kv)
                out.append(_f32(linear(rms_norm(x, p["out_norm"], te.cfg.rms_eps),
                                       p["lm_head"]))[0, -1])
                te.set_n_past(te.n_past + 1)
        return out

    def gap(xs, ys):
        return max(_rel(a, b) for a, b in zip(xs, ys))

    jax_gap = gap(j_fused, j_loop)
    port_gap = gap(t_run(k6.decode_layers_plain), t_run(layers_forward))
    print(f"{kernel} gemma vs the per-layer loop, L={n_layers}: JAX {jax_gap:.5f}, "
          f"port {port_gap:.5f}")
    assert port_gap <= 1.5 * jax_gap
