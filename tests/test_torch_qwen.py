"""The qwen families in the port (llama_cpp_gfx906_tpu_torch) against the JAX
package, on the CPU.

The slice on the tiny presets of ``tools/synth_gguf.py`` (2 layers, G 2,
hidden 256-512):
``tiny-qwen2`` (q/k/v biases), ``tiny-qwen2moe`` (biases, 8 experts and a
shared expert with its sigmoid gate, ``expert_weights_norm`` false),
``tiny-qwen3`` (qk-norm) and ``tiny-qwen3moe`` (qk-norm and 8 experts),
each in the Q4_K_M mix and, where a test needs int8, in Q8_0: the config,
the loader, the per-layer forward, the engines and the batched engine.
K6's three qwen modes (qk-norm without post-norms, MoE with qk-norm, the
shared expert): the plain version against the JAX kernel in interpret mode
on the JAX kernel tests' stacks (tests/test_decode_stream.py: L 3, D 256,
Q8_0 attention; its MoE test's int8 experts and its ``(shexp, gating,
wnorm)`` cases), and K6's and K7's gates against JAX's on every preset.

Tolerances, each the one the JAX package's own test of the same thing uses:
logits 2e-2 (``assert_allclose`` rtol = atol) and the same argmax for the
forward and the decode kernel, the KV rows 3e-2; engine logits at f32 1e-2
(max |port - jax| / max |jax|); greedy tokens exactly where the JAX top-2
margin exceeds twice that step's logit error (the JAX CPU path decodes
with bf16-dequantized weights, the port's GEMV plain version in f32: a
closer margin is a near-tie either may break, as tests/test_torch_moe.py
holds the MoE engines).  An MoE step whose router holds a near-tie (the
k-th and (k+1)-th probability of some layer within 1e-3, as the port
computes them) may choose another expert than JAX's: such a step's logits
are reported, not held, as chip_smoke.py reports the Mixtral router's.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_cpp_gfx906_tpu.gguf import GGMLType as JGGMLType
from llama_cpp_gfx906_tpu.gguf import GGUFReader as JReader
from llama_cpp_gfx906_tpu.gguf import quantize
from llama_cpp_gfx906_tpu.models.config import ModelConfig as JConfig
from llama_cpp_gfx906_tpu.models.config import config_from_gguf as j_config_from_gguf
from llama_cpp_gfx906_tpu.models.llama import KVCache as JKV
from llama_cpp_gfx906_tpu.models.llama import forward as j_forward
from llama_cpp_gfx906_tpu.ops import decode_stream as jk6
from llama_cpp_gfx906_tpu.ops import quant_matmul as jqmm
from llama_cpp_gfx906_tpu.ops.decode_step import _fused_ok as j_fused_ok
from llama_cpp_gfx906_tpu.ops.norms import rms_norm as j_rms_norm
from llama_cpp_gfx906_tpu.runtime.engine import Engine as JEngine
from llama_cpp_gfx906_tpu.runtime.weights import fuse_projections as j_fuse
from llama_cpp_gfx906_tpu_torch.gguf.constants import GGMLType, Keys
from llama_cpp_gfx906_tpu_torch.gguf.reader import GGUFReader
from llama_cpp_gfx906_tpu_torch.models.config import ModelConfig, config_from_gguf
from llama_cpp_gfx906_tpu_torch.models.llama import KVCache, forward
from llama_cpp_gfx906_tpu_torch.ops import decode_step as k7
from llama_cpp_gfx906_tpu_torch.ops import decode_stream as k6
from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as tqmm
from llama_cpp_gfx906_tpu_torch.ops.norms import rms_norm
from llama_cpp_gfx906_tpu_torch.ops.quant_matmul import linear
from llama_cpp_gfx906_tpu_torch.runtime.batch_engine import BatchedEngine, SamplerConfig
from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
from llama_cpp_gfx906_tpu_torch.runtime.weights import layer_table, params_from_jax
from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

PRESETS = ("tiny-qwen2", "tiny-qwen2-q8_0", "tiny-qwen2moe", "tiny-qwen2moe-q8_0",
           "tiny-qwen3", "tiny-qwen3-q8_0", "tiny-qwen3moe")
FIELDS = ("arch", "n_layers", "n_embd", "n_heads", "n_kv_heads", "head_dim", "n_ff",
          "n_vocab", "rms_eps", "rope_base", "rope_interleaved", "qk_norm",
          "post_attn_norm", "post_ffn_norm", "act_fn", "attn_bias", "n_experts",
          "n_experts_used", "expert_ff", "expert_weights_norm", "expert_weights_scale",
          "expert_gating_func")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("qwen")
    out = {p: write_synth(str(d / f"{p}.gguf"), p, seed=0) for p in PRESETS}
    for p in ("tiny-qwen2moe", "tiny-qwen2moe-q8_0"):  # the stack JAX's K6 gate takes
        out[f"{p}-nobias"] = write_synth(str(d / f"{p}-nobias.gguf"), p, seed=0,
                                         attn_bias=False)
    return out


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def port_cfg(jcfg) -> ModelConfig:
    names = [f.name for f in dataclasses.fields(ModelConfig) if f.name != "rope_scaling"]
    return ModelConfig(**{n: getattr(jcfg, n) for n in names})


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", PRESETS)
def test_config_matches_jax(files, preset):
    """Every field the port reads, as JAX's ``config_from_gguf``: biases and
    NEOX for qwen2 / qwen2moe, qk-norm and NEOX for qwen3 / qwen3moe, the
    experts' routing (qwen2moe: no renormalisation)."""
    jcfg = j_config_from_gguf(JReader(files[preset]))
    cfg = config_from_gguf(GGUFReader(files[preset]))
    for f in FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    qwen2 = cfg.arch.startswith("qwen2")
    assert (cfg.attn_bias, cfg.qk_norm, cfg.rope_interleaved) == (qwen2, not qwen2, False)
    if cfg.arch == "qwen2moe":
        assert not cfg.expert_weights_norm
        assert GGUFReader(files[preset]).get(
            Keys.LLM.EXPERT_SHARED_FEED_FORWARD_LENGTH) == 512
    if cfg.arch == "qwen3moe":
        assert cfg.expert_weights_norm and cfg.n_experts == 8


class _Alias:
    """A reader of the ``tiny`` llama file that calls itself ``arch``."""

    def __init__(self, reader, arch):
        self.reader, self.architecture = reader, arch

    def get(self, key, default=None, arch=None):
        return self.reader.get(key, default, arch="llama")


@pytest.mark.parametrize("arch", ["llama2", "llama3", "mistral", "mixtral", "tinyllama"])
def test_config_llama_aliases_match_jax(tmp_path, arch):
    """The plain llama aliases JAX's forward covers load as llama, with the
    JAX package's fields."""
    path = write_synth(str(tmp_path / "tiny.gguf"), "tiny", seed=0)
    jcfg = j_config_from_gguf(_Alias(JReader(path), arch))
    cfg = config_from_gguf(_Alias(GGUFReader(path), arch))
    for f in FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.arch == arch and cfg.rope_interleaved and not cfg.attn_bias


@pytest.mark.parametrize("arch", ["qwen2vl", "qwen", "llama4", "phi3"])
def test_config_refuses_unported_archs(arch):
    class Reader:
        architecture = arch

    with pytest.raises(NotImplementedError, match="'qwen3moe'"):
        config_from_gguf(Reader())


def test_chunk_grid_matches_jax():
    """The pure functions that decide whether a Q4_K_M qwen reaches K6, at
    the published widths (Qwen3-8B 4096 / 12288, Qwen3-30B-A3B 2048 and its
    768 experts padded to 1024, Qwen2.5-7B 3584 / 18944, Qwen1.5-MoE 5632
    and its 1408 experts padded to 1536): the nib4c chunk, K6's K chunk and
    the per-model scale fold."""
    for K in (4096, 12288, 2048, 1024, 3584, 18944, 5632, 1536):
        assert tqmm.nib4c_chunk(K) == jqmm.nib4c_chunk(K)
        for g in (16, 32):
            assert k6._proj_tk(K, g, True) == jk6._proj_tk(K, g, True)
            assert k6._proj_tk(K, g, False) == jk6._proj_tk(K, g, False)
        for jt, t in ((JGGMLType.Q4_K, GGMLType.Q4_K), (JGGMLType.Q6_K, GGMLType.Q6_K)):
            assert tqmm._fold_streams(K, t) == jqmm._fold_streams(K, jt)
    assert tqmm._fold_streams(4096, GGMLType.Q4_K) and tqmm._fold_streams(12288, GGMLType.Q4_K)
    assert not tqmm._fold_streams(3584, GGMLType.Q4_K)  # Qwen2.5-7B: plain scales


# ---------------------------------------------------------------------------
# the loader, the forward and the engines on the synthetic files
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _engines(path):
    """The JAX and the port's engines on ``path`` at f32."""
    return (JEngine.from_gguf(path, max_seq=256, dtype=jnp.float32),
            Engine.from_gguf(path, max_seq=256, dtype=torch.float32, device="cpu"))


@pytest.mark.parametrize("preset", PRESETS)
def test_loader_matches_jax(files, preset):
    """Byte-equal planes and vectors as the JAX loader's: the fused q|k|v
    (a biased Q4_K_M stack repacks its nib4c q and k to int8 beside the
    Q6_K v, harmonizing the groups) with ``bqkv_fused``, the fused shared
    expert ``shexp_gateup_fused`` and its gate vector, the padded experts,
    the qk-norm vectors; ``params_from_jax`` of the JAX tree gives the
    loader's logits."""
    je, te = _engines(files[preset])
    jl, tl = je.params["layers"], te.params["layers"]
    assert sorted(tl[0].keys()) == sorted(jl.keys())
    arch = te.cfg.arch
    want = {"qwen2": {"bqkv_fused", "wqkv_fused"}, "qwen3": {"q_norm", "k_norm"},
            "qwen2moe": {"bqkv_fused", "shexp_gateup_fused", "shexp_down",
                         "shexp_gate_inp", "moe_gate"},
            "qwen3moe": {"q_norm", "k_norm", "moe_gate"}}[arch]
    assert want <= set(jl)
    for key, jv in jl.items():
        for i, layer in enumerate(tl):
            tv = layer[key]
            for name in (("q", "s", "m", "sd", "md") if hasattr(jv, "fmt") else (None,)):
                if name and getattr(jv, name) is None:
                    assert getattr(tv, name) is None
                    continue
                a = np.asarray(getattr(jv, name) if name else jv)
                b = getattr(tv, name) if name else tv
                if key == "moe_gate_inp":  # the port's router is f32 of the same values
                    np.testing.assert_array_equal(b.numpy(), a[i].astype(np.float32))
                    continue
                assert a[i].tobytes() == b.numpy().tobytes(), (key, name, i)
            if hasattr(jv, "fmt"):
                assert (tv.fmt, tv.group, tv.shape, tv.sgroup) == \
                    (jv.fmt, jv.group, tuple(jv.shape), jv.sgroup or 0), key
    if te.cfg.n_experts:  # the expert FF padded to the 512 grid
        assert tl[0]["moe_gate"].N % 512 == 0 and tl[0]["moe_down"].K == tl[0]["moe_gate"].N
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, je.params), te.cfg)
    toks = torch.tensor([[0, 5, 77, 300, 12, 9]])
    outs = []
    for p in (params, te.params):
        kv = KVCache.create(te.cfg, 1, 16, torch.float32)
        outs.append(forward(p, te.cfg, toks, kv)[0].numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("preset", PRESETS)
def test_forward_matches_jax(files, preset):
    """``forward`` (the per-layer loop on the CPU) against the JAX forward at
    f32 on the same file: a 40-token prompt, then 3 decode steps, each fed
    the JAX greedy token; max |port - jax| / max |jax| within 2e-2 and the
    same argmax."""
    je, te = _engines(files[preset])
    cfg, jcfg = te.cfg, je.cfg
    rng = np.random.default_rng(1)
    prompt = rng.integers(3, cfg.n_vocab, (1, 40))
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


def _router_gap(record: list):
    """A ``moe.route`` that appends each call's smallest gap between the
    k-th and (k+1)-th expert probability to ``record``."""
    from llama_cpp_gfx906_tpu_torch.ops import moe

    route = moe.route

    def recording(logits, cfg):
        p = torch.softmax(logits.float(), -1).sort(-1, descending=True).values
        k = cfg.n_experts_used
        record.append(float((p[:, k - 1] - p[:, k]).min()))
        return route(logits, cfg)

    return recording


@pytest.mark.parametrize("preset", ["tiny-qwen2", "tiny-qwen2moe", "tiny-qwen3",
                                    "tiny-qwen3moe"])
def test_engine_greedy_matches_jax(files, preset, monkeypatch):
    """``Engine`` against the JAX ``Engine`` at f32: prefill and 12 decode
    steps' logits within 1e-2 (MoE: the steps before the first router
    near-tie, after which the two caches differ), each step's greedy token
    equal where the JAX margin is clear (see the module docstring)."""
    from llama_cpp_gfx906_tpu_torch.ops import moe

    je, te = _engines(files[preset])
    gaps: list = []
    monkeypatch.setattr(moe, "route", _router_gap(gaps))
    ids = je.tokenizer.tokenize("tok5 tok77 the quick brown fox jumps over tok300",
                                add_special=True, parse_special=True)
    je.reset()
    te.reset()
    a, b = je.prefill(ids), te.prefill(ids)
    assert _rel(b, a) < 1e-2
    tok, tied = int(np.argmax(a)), False
    for _ in range(12):
        gaps.clear()
        a, b = je.decode_one(tok), te.decode_one(tok)
        err = _rel(b, a)
        tied = tied or min(gaps, default=1.0) <= 1e-3
        if not tied:  # after a near-tie the two caches differ
            assert err < 1e-2
            top2 = np.sort(a)[-2:]
            if top2[1] - top2[0] > 2 * err * np.abs(a).max():
                assert int(np.argmax(b)) == int(np.argmax(a))
        tok = int(np.argmax(a))
    assert not tied or te.cfg.n_experts
    print(f"{preset}: router near-tie in 12 steps: {tied}")


@pytest.mark.parametrize("preset", ["tiny-qwen3", "tiny-qwen2moe"])
def test_batched_engine_matches_single_stream(files, preset):
    """``BatchedEngine`` at 2 slots (each prompt prefilled in one chunk, as
    the single stream prefills it: a chunk of other length rounds its
    dequantized prefill weights apart, then the batched decode step) gives
    each prompt the single-stream greedy tokens."""
    path = files[preset]
    single = _engines(path)[1]
    be = BatchedEngine.from_gguf(path, dtype=torch.float32, device="cpu", n_slots=2,
                                 max_seq=128, n_chunk=64)
    prompts = ["the quick brown fox jumps over the lazy dog", "tok5 tok7 jumps over tok9"]
    want = [single.generate(p, n_predict=8, stop_on_eog=False)[1] for p in prompts]
    slots = [be.add_request(be.tokenizer.tokenize(p, add_special=True, parse_special=True),
                            8, SamplerConfig(temp=0.0)) for p in prompts]
    got = {s.id: [] for s in slots}
    while any(s.stop_reason is None for s in slots):
        for s, t, _ in be.step():
            got[s.id].append(t)
    assert [got[s.id] for s in slots] == want


# ---------------------------------------------------------------------------
# the decode gates on every preset
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", PRESETS + ("tiny-qwen2moe-nobias",
                                              "tiny-qwen2moe-q8_0-nobias"))
def test_decode_gates_match_jax(files, preset):
    """K6's and K7's gates decide as JAX's on each preset's parameters
    (B 1, bf16 cache): the biased qwen2 and qwen2moe stacks are refused by
    both (``bqkv_fused``), a bias-free qwen2moe (its shared expert fused) and
    the qwen3 / qwen3moe stacks in the Q4_K_M mix are taken by K6."""
    je, te = _engines(files[preset])
    jkv = JKV.create(je.cfg, batch=1, max_seq=256, dtype=jnp.bfloat16)
    kv = KVCache.create(te.cfg, 1, 256, torch.bfloat16)
    want = (jk6._stream_ok(je.params, je.cfg, jkv, 1, 1),
            j_fused_ok(je.params, je.cfg, jkv, 1, 1))
    got = (k6._stream_ok(te.params, te.cfg, kv, 1, 1),
           k7._fused_ok(te.params, te.cfg, kv, 1, 1))
    assert got == want
    if preset in ("tiny-qwen2", "tiny-qwen2-q8_0", "tiny-qwen2moe", "tiny-qwen2moe-q8_0"):
        assert want == (False, False)
    if preset in ("tiny-qwen3", "tiny-qwen3moe", "tiny-qwen2moe-nobias"):
        assert want[0]


def test_layer_table_shared_expert_words(files):
    """A bias-free qwen2moe stack's plane table: the shared expert's gate|up
    and down in the dense gate|up and down slots, its gate vector (an f32
    copy) in the last word."""
    te = _engines(files["tiny-qwen2moe-q8_0-nobias"])[1]
    table = layer_table(te.params, te.cfg)
    assert table.shape == (2, k6.TABLE_W) == (2, 50)
    gates = te.params.__dict__["_shexp_gates"]
    for li, p in enumerate(te.params["layers"]):
        row = table[li].tolist()
        assert row[15] == p["shexp_gateup_fused"].q.data_ptr()
        assert row[16] == p["shexp_gateup_fused"].s.data_ptr()
        assert row[20] == p["shexp_down"].q.data_ptr()
        assert row[29] == p["moe_gate"].q.data_ptr()
        assert row[49] == gates[li].data_ptr()
        torch.testing.assert_close(gates[li], p["shexp_gate_inp"].float().reshape(-1))


# ---------------------------------------------------------------------------
# K6's qwen modes: the plain version against the JAX kernel
# ---------------------------------------------------------------------------

L, D, HQ, HKV, DH, F, V, S = 3, 256, 2, 1, 128, 512, 64, 256


def _qstack(rng, K, N):
    w = rng.standard_normal((N, K), dtype=np.float32) * 0.05
    qt = jqmm.pack_gguf_tensor(quantize(w, JGGMLType.Q8_0), JGGMLType.Q8_0, (N, K))
    return jqmm.QuantTensor(q=jnp.stack([qt.q] * L), s=jnp.stack([qt.s] * L), m=None,
                            fmt=qt.fmt, group=qt.group, shape=qt.shape)


def _estack(rng, E, K, N, g=16):
    """Stacked int8 affine experts (the JAX MoE kernel test's ``estack``)."""
    q = rng.integers(0, 16, (E, K, N)).astype(np.int8)
    s = rng.uniform(0.002, 0.006, (E, K // g, N)).astype(np.float32)
    m = rng.uniform(0.0, 0.05, (E, K // g, N)).astype(np.float32)
    st = lambda a: jnp.stack([jnp.asarray(a)] * L)  # noqa: E731
    return jqmm.QuantTensor(q=st(q), s=st(s), m=st(m), fmt="int8", group=g, shape=(K, N))


def qwen_params(seed, qk_norm=False, E=0, shexp=False, sgi=True, hq=HQ):
    """The JAX decode-stream tests' stack (Q8_0 attention; dense Q8_0 FFN,
    or 8 stacked int8 experts of 256 and a shared expert of 512 with its
    gate vector, as ``moe_params``), with per-head q/k norms for qwen3."""
    rng = np.random.default_rng(seed)
    layers = {
        "attn_norm": jnp.ones((L, D), jnp.float32) * 1.1,
        "ffn_norm": jnp.ones((L, D), jnp.float32) * 0.9,
        "wq": _qstack(rng, D, hq * DH), "wk": _qstack(rng, D, HKV * DH),
        "wv": _qstack(rng, D, HKV * DH), "wo": _qstack(rng, hq * DH, D)}
    if E:
        layers.update(moe_gate_inp=jnp.asarray(rng.standard_normal((L, D, E)) * 0.3,
                                               jnp.float32),
                      moe_gate=_estack(rng, E, D, 256), moe_up=_estack(rng, E, D, 256),
                      moe_down=_estack(rng, E, 256, D))
        if shexp:
            layers.update(shexp_gate=_qstack(rng, D, F), shexp_up=_qstack(rng, D, F),
                          shexp_down=_qstack(rng, F, D))
            if sgi:
                layers["shexp_gate_inp"] = jnp.asarray(
                    rng.standard_normal((L, D, 1)) * 0.1, jnp.float32)
    else:
        layers.update(w_gate=_qstack(rng, D, F), w_up=_qstack(rng, D, F),
                      w_down=_qstack(rng, F, D))
    if qk_norm:
        for k in ("q_norm", "k_norm"):
            layers[k] = jnp.asarray(1.0 + 0.1 * rng.standard_normal((L, DH)), jnp.float32)
    head = rng.standard_normal((V, D), dtype=np.float32) * 0.05
    return {"tok_emb": jnp.asarray(rng.standard_normal((V, D)) * 0.1, jnp.bfloat16),
            "out_norm": jnp.ones(D, jnp.float32),
            "lm_head": jqmm.pack_gguf_tensor(quantize(head, JGGMLType.Q8_0),
                                             JGGMLType.Q8_0, (V, D)),
            "layers": j_fuse(layers)}


def qwen_cfg(arch, **kw):
    base = dict(rope_interleaved=False, rope_base=1e6, rms_eps=1e-6,
                qk_norm=arch.startswith("qwen3"))
    base.update(kw)
    return JConfig(arch=arch, n_layers=L, n_embd=D, n_heads=base.pop("n_heads", HQ),
                   n_kv_heads=HKV, head_dim=DH, n_ff=F, n_vocab=V, n_ctx_train=S, **base)


@functools.lru_cache(maxsize=None)
def _j_kernel(jcfg):
    return jax.jit(lambda p, x, kv: jk6.fused_decode_step_streamed(p, jcfg, x, kv,
                                                                   interpret=True))


def lockstep(jcfg, jparams, lens, steps=3, seed=7, moe=False):
    """Prefill each slot through the JAX forward, then ``steps`` tokens
    through the JAX kernel in interpret mode and the port's plain version
    from the same cache: logits 2e-2, the whole cache 3e-2, JAX's greedy
    token within 0.05 of the port's top logit in every slot (the JAX
    kernel test's check), and for an MoE stack, the chosen experts of
    every layer recorded."""
    cfg = port_cfg(jcfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    B = len(lens)
    rng = np.random.default_rng(seed)
    jkv = JKV.create(jcfg, batch=B, max_seq=S, dtype=jnp.bfloat16)
    toks = np.zeros((B, max(lens)), np.int32)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(0, V, n)
    _, jkv = j_forward(jparams, jcfg, jnp.asarray(toks), jkv,
                       n_tokens=jnp.asarray(lens, jnp.int32))
    kv = KVCache(k=_t(jkv.k), v=_t(jkv.v), n_past=torch.tensor(lens, dtype=torch.int32))
    assert jk6._stream_ok(jparams, jcfg, jkv, B, 1) and k6._stream_ok(params, cfg, kv, B, 1)
    tok = rng.integers(0, V, (B, 1)).astype(np.int32)
    for _ in range(steps):
        jx2, jk, jv = _j_kernel(jcfg)(jparams, jparams["tok_emb"][tok], jkv)
        jkv = JKV(k=jk, v=jv, n_past=jkv.n_past + 1)
        ids = []
        x2 = k6.decode_layers_plain(params, cfg, params["tok_emb"][torch.from_numpy(tok)],
                                    kv, ids_out=ids)
        kv.n_past += 1
        assert len(ids) == (L if moe else 0)
        jl = _f32(jqmm.linear(j_rms_norm(jx2, jparams["out_norm"], jcfg.rms_eps),
                              jparams["lm_head"]))
        tl = _f32(linear(rms_norm(x2, params["out_norm"], cfg.rms_eps), params["lm_head"]))
        np.testing.assert_allclose(tl, jl, rtol=2e-2, atol=2e-2)
        for b in range(B):  # the JAX test's argmax check: within rounding of the top
            assert tl[b, 0, int(np.argmax(jl[b, 0]))] >= tl[b, 0].max() - 0.05
        np.testing.assert_allclose(_f32(kv.k), _f32(jkv.k), rtol=3e-2, atol=3e-2)
        np.testing.assert_allclose(_f32(kv.v), _f32(jkv.v), rtol=3e-2, atol=3e-2)
        tok = np.argmax(jl[:, 0], -1).reshape(B, 1).astype(np.int32)


@pytest.mark.parametrize("lens", [(40,), (40, 7, 25)])
def test_k6_qk_norm_without_post_norms_matches_jax(lens):
    """qwen3: qk-norm, one rope base, silu, no post-norms (G 2), B 1 and 3."""
    lockstep(qwen_cfg("qwen3", n_heads=2 * HQ), qwen_params(11, qk_norm=True, hq=2 * HQ),
             lens)


@pytest.mark.parametrize("wnorm", [True, False])
def test_k6_moe_with_qk_norm_matches_jax(wnorm):
    """qwen3moe: the MoE branch (8 experts, top 2) beside per-head q/k norms."""
    jcfg = qwen_cfg("qwen3moe", n_experts=8, n_experts_used=2, expert_ff=256,
                    expert_weights_norm=wnorm)
    lockstep(jcfg, qwen_params(13, qk_norm=True, E=8), (40,), moe=True)


@pytest.mark.parametrize("shexp,gating,wnorm,sgi", [
    (True, 1, False, True),    # qwen2moe: softmax, no renorm, gated shared expert
    (True, 1, False, False),   # a shared expert without its gate
    (False, 1, True, False),   # mixtral / qwen3moe routing, no shared expert
    (False, 2, True, False),   # sigmoid gating
])
def test_k6_shared_expert_matches_jax(shexp, gating, wnorm, sgi):
    """The JAX MoE kernel test's cases (tests/test_decode_stream.py:495-507)
    on its stack, bias-free qwen2moe, plus the shared expert without its
    sigmoid gate."""
    jcfg = qwen_cfg("qwen2moe", qk_norm=False, n_experts=8, n_experts_used=2,
                    expert_ff=256, expert_weights_norm=wnorm, expert_gating_func=gating)
    jparams = qwen_params(29, E=8, shexp=shexp, sgi=sgi)
    assert ("shexp_gateup_fused" in jparams["layers"]) == shexp
    assert ("shexp_gate_inp" in jparams["layers"]) == sgi
    lockstep(jcfg, jparams, (7,), moe=True)


def test_k6_shared_expert_is_in_the_plain_ffn():
    """The plain MoE FFN of K6 with the shared expert: the routed experts'
    sum plus bf16(act(bf16 g)) * u through the down projection, scaled by
    sigmoid(h2 · gate) read from the f32 h2; removing the gate vector or the
    shared expert changes it."""
    jcfg = qwen_cfg("qwen2moe", qk_norm=False, n_experts=8, n_experts_used=2,
                    expert_ff=256, expert_weights_norm=False)
    cfg = port_cfg(jcfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, qwen_params(
        29, E=8, shexp=True)), cfg)
    p = params["layers"][0]
    h2 = torch.from_numpy(np.random.default_rng(3).standard_normal((1, D)).astype(np.float32))
    full = k6.moe_ffn_plain(h2, p, cfg)
    routed = k6.moe_ffn_plain(h2, {k: p[k] for k in p.keys() if not k.startswith("shexp")},
                              cfg)
    hb = k6._bf16r(h2)
    gu = k6.qlinear_plain(hb, p["shexp_gateup_fused"])
    y = k6._bf16r(k6._bf16r(torch.nn.functional.silu(k6._bf16r(gu[:, :F])))
                  * k6._bf16r(gu[:, F:]))
    sh = k6.qlinear_plain(y, p["shexp_down"])
    gate = torch.sigmoid(h2 @ p["shexp_gate_inp"].float())
    torch.testing.assert_close(full, sh * gate + routed, rtol=1e-5, atol=1e-5)
    assert _rel(sh * gate, full) > 1e-2  # the shared expert moves the output
