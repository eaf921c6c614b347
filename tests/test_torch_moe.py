"""The MoE slice of the port (Mixtral: llama with routed experts) against the
JAX package on the CPU: expert storage, the routed matmul (K8's plain
version), ``moe_ffn`` on both of its paths, the K6 MoE gate and plain
version, and the whole ``tiny-moe`` model through both engines.

Inputs come from numpy seeds.  Tolerances (max |port - jax| / max |jax|):
- expert planes: byte-equal (a Q4 tensor with no nib4c chunk too: split-K
  nib4 in both packages);
- routed matmul and ``moe_ffn``: 1e-5 where both sides compute in f32 from
  the same planes, 2e-2 against the JAX Pallas kernel (bf16 weights) and
  for ``moe_ffn``'s bf16 activations (as the JAX kernel tests);
- K6 MoE plain version against the JAX kernel in interpret mode: logits
  2e-2 and KV 3e-2 for Q8_0 experts, 8e-2 / 6e-2 for nib4c (the JAX
  decode-stream tests' bounds);
- engines: logits 1e-2 (the JAX CPU path dequantizes its dense weights to
  bf16, the port's GEMV plain version keeps f32), greedy tokens equal
  where the JAX top-2 margin exceeds twice that logit error.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_cpp_gfx906_tpu.gguf import GGMLType, quantize
from llama_cpp_gfx906_tpu.models.config import ModelConfig as JConfig
from llama_cpp_gfx906_tpu.models.llama import KVCache as JKV
from llama_cpp_gfx906_tpu.models.llama import forward as j_forward
from llama_cpp_gfx906_tpu.ops import moe as jmoe
from llama_cpp_gfx906_tpu.ops import quant_matmul as jqmm
from llama_cpp_gfx906_tpu.ops.decode_stream import _moe_stream_ok as j_moe_ok
from llama_cpp_gfx906_tpu.ops.decode_stream import _stream_ok as j_stream_ok
from llama_cpp_gfx906_tpu.ops.decode_stream import fused_decode_step_streamed as j_k6
from llama_cpp_gfx906_tpu.ops.norms import rms_norm as j_rms_norm
from llama_cpp_gfx906_tpu.runtime.engine import Engine as JEngine
from llama_cpp_gfx906_tpu.runtime.weights import fuse_projections as j_fuse
from llama_cpp_gfx906_tpu_torch.gguf.writer import GGUFWriter
from llama_cpp_gfx906_tpu_torch.models.config import ModelConfig
from llama_cpp_gfx906_tpu_torch.models.llama import KVCache, layer_bytes
from llama_cpp_gfx906_tpu_torch.ops import decode_stream as k6
from llama_cpp_gfx906_tpu_torch.ops import moe as tmoe
from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as tq
from llama_cpp_gfx906_tpu_torch.ops.norms import rms_norm
from llama_cpp_gfx906_tpu_torch.runtime.batch_engine import BatchedEngine, SamplerConfig
from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
from llama_cpp_gfx906_tpu_torch.runtime.weights import layer_table, params_from_jax
from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

L, D, HQ, HKV, DH, V, S = 3, 256, 2, 1, 128, 64, 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: one thread per pytest worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _port_qt(jt) -> tq.QuantTensor:
    take = (lambda a: None if a is None else _t(a))  # noqa: E731
    return tq.QuantTensor(take(jt.q), take(jt.s), take(jt.m), jt.fmt, jt.group,
                          jt.shape, take(jt.sd), take(jt.md), jt.sgroup or 0)


def _raw_experts(rng, qtype, E, N, K):
    w = rng.standard_normal((E * N, K), dtype=np.float32) / np.sqrt(K)
    return quantize(w, qtype)


# ---------------------------------------------------------------------------
# expert storage
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qtype,N,K,pad", [
    (GGMLType.Q8_0, 384, 512, "n"),     # pads 384 -> 512 output columns
    (GGMLType.Q8_0, 512, 384, "k"),     # pads 384 -> 512 input rows
    (GGMLType.Q4_K, 384, 512, "n"),     # nib4c
    (GGMLType.Q4_K, 256, 1024, ""),     # nib4c, 1024-row chunks
    (GGMLType.Q6_K, 256, 768, "k"),     # int8 g16, 768 -> 1024
    (GGMLType.Q4_0, 128, 2048, ""),     # nib4c, mins from the 8-offset
])
def test_pack_gguf_experts_byte_equal(qtype, N, K, pad):
    E = 3
    raw = _raw_experts(np.random.default_rng(1), qtype, E, N, K)
    kw = dict(pad_n=pad == "n", pad_k=pad == "k")
    jt = jqmm.pack_gguf_experts(raw, qtype, (E, N, K), put=np.asarray, **kw)
    tt = tq.pack_gguf_experts(raw, qtype, (E, N, K), **kw)
    assert (tt.fmt, tt.group, tt.shape) == (jt.fmt, jt.group, tuple(jt.shape))
    for name in ("q", "s", "m"):
        a, b = getattr(jt, name), getattr(tt, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert np.asarray(a).tobytes() == b.numpy().tobytes(), name
    dq = tq.dequantize_qt_experts(tt, torch.float32)
    np.testing.assert_array_equal(
        dq.numpy(), np.asarray(jqmm.dequantize_qt_experts(jt, jnp.float32)))


@pytest.mark.parametrize("qtype,pad", [(GGMLType.Q4_K, "k"), (GGMLType.Q6_K, ""),
                                       (GGMLType.Q8_0, "n")])
def test_pack_experts_int8_g16_byte_equal(qtype, pad):
    E, N, K = 2, 384, 768
    raw = _raw_experts(np.random.default_rng(2), qtype, E, N, K)
    kw = dict(pad_n=pad == "n", pad_k=pad == "k")
    jt = jqmm.pack_experts_int8_g16(raw, qtype, (E, N, K), put=np.asarray, **kw)
    tt = tq.pack_experts_int8_g16(raw, qtype, (E, N, K), **kw)
    assert (tt.fmt, tt.group, tt.shape) == ("int8", 16, tuple(jt.shape))
    for name in ("q", "s", "m"):
        assert np.asarray(getattr(jt, name)).tobytes() == getattr(tt, name).numpy().tobytes()


def test_q4_without_nib4c_chunk_is_int8_with_mins():
    """K = 320 has no nib4c chunk: both packages pack split-K nib4 (the port
    stored int8 values with mins until the nib4 modes of K5 and K8 were
    ported; the name is kept); the same bytes, equal dequantized values,
    and the routed matmul agrees."""
    E, N, K = 2, 128, 320
    raw = _raw_experts(np.random.default_rng(3), GGMLType.Q4_0, E, N, K)
    jt = jqmm.pack_gguf_experts(raw, GGMLType.Q4_0, (E, N, K), put=np.asarray)
    tt = tq.pack_gguf_experts(raw, GGMLType.Q4_0, (E, N, K))
    assert jt.fmt == tt.fmt == "nib4" and tt.m is not None
    for name in ("q", "s", "m"):
        assert np.asarray(getattr(jt, name)).tobytes() == getattr(tt, name).numpy().tobytes()
    np.testing.assert_array_equal(
        tq.dequantize_qt_experts(tt, torch.float32).numpy(),
        np.asarray(jqmm.dequantize_qt_experts(jt, jnp.float32)))
    x = np.random.default_rng(4).standard_normal((3, K)).astype(np.float32)
    idx = np.array([1, 0, 1], np.int32)
    ref = jqmm.routed_quant_matmul_xla(jnp.asarray(x), jt, jnp.asarray(idx))
    got = tq.routed_quant_matmul_plain(torch.from_numpy(x), tt, torch.from_numpy(idx).long())
    assert _rel(got, ref) < 1e-5


def _mixed_gguf(path):
    """A 2-layer MoE llama whose ffn_down_exps is Q4_K in layer 0 and Q6_K in
    layer 1 (llama.cpp's Q4_K_M bumps some), with an expert FF of 768."""
    E, EF, Dm = 4, 768, 256
    rng = np.random.default_rng(5)
    w = GGUFWriter(path, "llama")
    for k, v in (("llama.block_count", 2), ("llama.embedding_length", Dm),
                 ("llama.attention.head_count", 2), ("llama.attention.head_count_kv", 1),
                 ("llama.attention.key_length", 128), ("llama.feed_forward_length", EF),
                 ("llama.context_length", 256), ("llama.vocab_size", 300),
                 ("llama.expert_count", E), ("llama.expert_used_count", 2)):
        w.add_uint32(k, v)
    w.add_float32("llama.attention.layer_norm_rms_epsilon", 1e-5)
    w.add_string("tokenizer.ggml.model", "llama")
    toks = ["<s>", "</s>", "<unk>"] + [f"<0x{b:02X}>" for b in range(256)]
    toks += [f"w{i}" for i in range(300 - len(toks))]
    w.add_array("tokenizer.ggml.tokens", toks)
    w.add_array("tokenizer.ggml.scores", [0.0] * 300)
    w.add_array("tokenizer.ggml.token_type", [3, 3, 2] + [6] * 256 + [1] * 41)

    def add(name, shape, qtype):
        arr = (rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(np.float32)
        w.add_tensor(name, quantize(arr.reshape(-1, shape[-1]), qtype),
                     ggml_type=qtype, raw_ne=tuple(reversed(shape)))

    w.add_tensor("token_embd.weight", rng.standard_normal((300, Dm)).astype(np.float16))
    w.add_tensor("output_norm.weight", np.ones(Dm, np.float32))
    add("output.weight", (300, Dm), GGMLType.Q8_0)
    for i in range(2):
        w.add_tensor(f"blk.{i}.attn_norm.weight", np.ones(Dm, np.float32))
        w.add_tensor(f"blk.{i}.ffn_norm.weight", np.ones(Dm, np.float32))
        for n, shape in (("attn_q", (256, Dm)), ("attn_k", (128, Dm)),
                         ("attn_v", (128, Dm)), ("attn_output", (Dm, 256))):
            add(f"blk.{i}.{n}.weight", shape, GGMLType.Q8_0)
        w.add_tensor(f"blk.{i}.ffn_gate_inp.weight",
                     (rng.standard_normal((E, Dm)) / 16).astype(np.float32))
        add(f"blk.{i}.ffn_gate_exps.weight", (E, EF, Dm), GGMLType.Q4_K)
        add(f"blk.{i}.ffn_up_exps.weight", (E, EF, Dm), GGMLType.Q4_K)
        add(f"blk.{i}.ffn_down_exps.weight", (E, Dm, EF),
            (GGMLType.Q4_K, GGMLType.Q6_K)[i])
    w.write()


def test_loader_mixed_expert_types_byte_equal(tmp_path):
    """Mixed types across layers unify to int8/g16 (down) while gate/up stay
    nib4c, the FF pads 768 -> 1024, and the router is f32 (D, E): every
    layer's planes byte-equal to the JAX loader's, one layout per layer."""
    path = str(tmp_path / "mixed.gguf")
    _mixed_gguf(path)
    je = JEngine.from_gguf(path, max_seq=64, dtype=jnp.float32)
    te = Engine.from_gguf(path, max_seq=64, dtype=torch.float32, device="cpu")
    jl, tl = je.params["layers"], te.params["layers"]
    assert sorted(tl[0].keys()) == sorted(jl.keys())
    assert (tl[0]["moe_down"].fmt, tl[0]["moe_down"].group) == ("int8", 16)
    assert tl[0]["moe_gate"].fmt == "nib4c" and tl[0]["moe_gate"].shape == (256, 1024)
    assert tl[0]["moe_gate_inp"].dtype == torch.float32
    for key, jv in jl.items():
        for i, layer in enumerate(tl):
            for name in (("q", "s", "m", "sd", "md") if hasattr(jv, "fmt") else (None,)):
                a = getattr(jv, name) if name else jv
                b = getattr(layer[key], name) if name else layer[key]
                assert (a is None) == (b is None), (key, name)
                if a is not None:
                    assert np.asarray(a)[i].tobytes() == b.numpy().tobytes(), (key, name, i)
    assert k6.uniform_layers(tl, k6.proj_keys(tl[0]))


# ---------------------------------------------------------------------------
# the routed matmul
# ---------------------------------------------------------------------------


def _experts(qtype, E=4, N=256, K=512, seed=6, g16=False):
    raw = _raw_experts(np.random.default_rng(seed), qtype, E, N, K)
    pack = jqmm.pack_experts_int8_g16 if g16 else jqmm.pack_gguf_experts
    return pack(raw, qtype, (E, N, K), put=np.asarray)


@pytest.mark.parametrize("qtype,g16", [(GGMLType.Q8_0, False), (GGMLType.Q4_K, False),
                                       (GGMLType.Q6_K, False), (GGMLType.Q4_K, True)])
def test_routed_plain_matches_jax_xla(qtype, g16):
    jt = _experts(qtype, g16=g16)
    x = np.random.default_rng(7).standard_normal((6, 512)).astype(np.float32)
    idx = np.array([3, 0, 3, 1, 2, 0], np.int32)
    ref = jqmm.routed_quant_matmul_xla(jnp.asarray(x), jt, jnp.asarray(idx))
    got = tq.routed_quant_matmul_plain(torch.from_numpy(x), _port_qt(jt),
                                       torch.from_numpy(idx).long())
    assert got.shape == (6, 256) and _rel(got, ref) < 1e-5


@pytest.mark.parametrize("qtype,g16", [(GGMLType.Q8_0, False), (GGMLType.Q6_K, False),
                                       (GGMLType.Q4_K, True)])  # the last with mins
def test_k8_plain_matches_jax_pallas_interpret(qtype, g16):
    """K8's plain version (its rounding points: bf16 x, bf16(q*s - m)) and
    the CPU dispatch against the JAX K8 in interpret mode, as
    tests/test_quant_matmul.py runs it."""
    jt = _experts(qtype, g16=g16)
    assert jt.fmt == "int8" and (jt.m is not None) == g16
    x = np.random.default_rng(8).standard_normal((5, 512)).astype(np.float32) * 0.5
    idx = np.array([2, 2, 0, 3, 1], np.int32)
    ref = jqmm._routed_qmm_pallas(jnp.asarray(x), jt.q, jt.s, jt.m, jnp.asarray(idx),
                                  fmt=jt.fmt, group=jt.group, shape=jt.shape,
                                  has_m=jt.m is not None, interpret=True)
    tt = _port_qt(jt)
    xt, it = torch.from_numpy(x), torch.from_numpy(idx)
    assert tq.qmm_tileable(tt)
    assert _rel(tq.rqmm_int8(xt, tt, it), ref) < 1e-5  # CPU: the plain version
    assert _rel(tq.routed_quant_matmul(xt, tt, it.long()), ref) < 2e-2


def test_k8_gate_matches_jax():
    """K8's gate is the JAX package's (``_pallas_tileable``, no folds):
    nib4c refused, N % 128, and K tiles."""
    for jt in (_experts(GGMLType.Q8_0), _experts(GGMLType.Q4_K),
               _experts(GGMLType.Q8_0, N=96, K=512), _experts(GGMLType.Q8_0, K=160)):
        want = jqmm._pallas_tileable(jt.fmt, jt.group, jt.shape, jt.q.shape[-1])
        assert tq.qmm_tileable(_port_qt(jt)) == want


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------


def _moe_inputs(qtype, E=4, Dm=256, EF=512, seed=9):
    rng = np.random.default_rng(seed)
    jq = {k: jqmm.pack_gguf_experts(_raw_experts(rng, qtype, E, n, kk), qtype,
                                    (E, n, kk), put=jnp.asarray)
          for k, n, kk in (("g", EF, Dm), ("u", EF, Dm), ("d", Dm, EF))}
    gate_inp = (rng.standard_normal((Dm, E)) / np.sqrt(Dm)).astype(np.float32)
    return jq, gate_inp


@pytest.mark.parametrize("B,T,qtype,gating,wnorm,scale", [
    (1, 3, GGMLType.Q8_0, 1, True, 1.0),    # routed, K8's operand format
    (2, 4, GGMLType.Q4_K, 1, True, 1.0),    # routed, nib4c (the gather)
    (1, 1, GGMLType.Q8_0, 2, False, 2.5),   # sigmoid, no renorm, scaled
    (1, 2, GGMLType.Q4_K, 2, True, 0.5),
    (2, 7, GGMLType.Q8_0, 1, True, 1.0),    # dense all-experts path
    (1, 12, GGMLType.Q4_K, 1, False, 1.0),
    (3, 5, GGMLType.Q4_K, 2, True, 2.5),
])
def test_moe_ffn_matches_jax(B, T, qtype, gating, wnorm, scale):
    jq, gate_inp = _moe_inputs(qtype)
    kw = dict(arch="llama", n_layers=1, n_embd=256, n_heads=2, n_kv_heads=1,
              head_dim=128, n_ff=512, n_vocab=V, n_ctx_train=S, n_experts=4,
              n_experts_used=2, expert_weights_norm=wnorm,
              expert_weights_scale=scale, expert_gating_func=gating)
    jcfg, cfg = JConfig(**kw), ModelConfig(**kw)
    x = (np.random.default_rng(10).standard_normal((B, T, 256)) * 0.5).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    ref = jmoe.moe_ffn(jx, jnp.asarray(gate_inp), jq["g"], jq["u"], jq["d"], jcfg)
    got = tmoe.moe_ffn(_t(jx), torch.from_numpy(gate_inp), _port_qt(jq["g"]),
                       _port_qt(jq["u"]), _port_qt(jq["d"]), cfg)
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, 256)
    assert _rel(got, ref) < 2e-2


def test_moe_ffn_dense_experts_match_jax():
    """Unquantized (E, K, N) experts, both paths."""
    rng = np.random.default_rng(11)
    E, Dm, EF = 4, 128, 256
    w = {k: (rng.standard_normal((E, a, b)) / np.sqrt(a)).astype(np.float32)
         for k, a, b in (("g", Dm, EF), ("u", Dm, EF), ("d", EF, Dm))}
    gi = (rng.standard_normal((Dm, E)) / np.sqrt(Dm)).astype(np.float32)
    kw = dict(arch="llama", n_layers=1, n_embd=Dm, n_heads=1, n_kv_heads=1,
              head_dim=128, n_ff=EF, n_vocab=V, n_ctx_train=S, n_experts=E,
              n_experts_used=2, expert_weights_norm=True)
    for T in (4, 20):
        x = rng.standard_normal((1, T, Dm)).astype(np.float32)
        ref = jmoe.moe_ffn(jnp.asarray(x), jnp.asarray(gi), *(jnp.asarray(w[k]) for k in "gud"),
                           JConfig(**kw))
        got = tmoe.moe_ffn(torch.from_numpy(x), torch.from_numpy(gi),
                           *(torch.from_numpy(w[k]) for k in "gud"), ModelConfig(**kw))
        assert _rel(got, ref) < 1e-5


@pytest.mark.parametrize("variant", ["probs_bias", "router_b", "gate_b", "down_b",
                                     "gate_x", "moe_topk_softmax", "moe_scale_input"])
def test_moe_ffn_unported_variants_raise(variant):
    """deepseek3's selection bias, smallthinker's router input and llama4's
    input scaling still raise, naming themselves; gpt-oss's variants (the
    router bias, the expert biases, the softmax over the top-k logits) are
    ported since the gpt-oss slice, so their cases (names kept) now hold
    the port to the JAX ``moe_ffn`` on the routed path at 2e-2 (bf16)."""
    jq, gate_inp = _moe_inputs(GGMLType.Q8_0)
    kw = dict(arch="llama", n_layers=1, n_embd=256, n_heads=2, n_kv_heads=1,
              head_dim=128, n_ff=512, n_vocab=V, n_ctx_train=S, n_experts=4,
              n_experts_used=2)
    rng = np.random.default_rng(12)
    shapes = {"router_b": (4,), "gate_b": (4, 512), "down_b": (4, 256)}
    extra = {}
    if variant.startswith("moe_"):
        kw[variant] = True
    elif variant in shapes:
        extra[variant] = (0.1 * rng.standard_normal(shapes[variant])).astype(np.float32)
    else:
        extra[variant] = np.zeros(4, np.float32)
    xn = rng.standard_normal((1, 2, 256)).astype(np.float32)
    x = torch.from_numpy(xn).to(torch.bfloat16)
    port = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in extra.items()}
    args = (torch.from_numpy(gate_inp), _port_qt(jq["g"]), _port_qt(jq["u"]),
            _port_qt(jq["d"]), ModelConfig(**kw))
    if variant in ("probs_bias", "gate_x", "moe_scale_input"):
        with pytest.raises(NotImplementedError, match=variant):
            tmoe.moe_ffn(x, *args, **port)
        return
    got = tmoe.moe_ffn(x, *args, **port)
    ref = jmoe.moe_ffn(jnp.asarray(xn, jnp.bfloat16), jnp.asarray(gate_inp), jq["g"],
                       jq["u"], jq["d"], JConfig(**kw),
                       **{k: jnp.asarray(v, jnp.bfloat16) for k, v in extra.items()})
    assert _rel(got, ref) < 2e-2


def test_route_takes_the_first_maximum_on_ties():
    cfg = ModelConfig(arch="llama", n_layers=1, n_embd=8, n_heads=1, n_kv_heads=1,
                      head_dim=8, n_ff=8, n_vocab=8, n_ctx_train=8, n_experts=4,
                      n_experts_used=2, expert_weights_norm=True)
    w, ids = tmoe.route(torch.tensor([[1.0, 3.0, 3.0, 3.0]]), cfg)
    assert ids.tolist() == [[1, 2]] and torch.allclose(w, torch.tensor([[0.5, 0.5]]))
    _, jids = jax.lax.top_k(jax.nn.softmax(jnp.asarray([[1.0, 3.0, 3.0, 3.0]])), 2)
    assert np.asarray(jids).tolist() == ids.tolist()


# ---------------------------------------------------------------------------
# K6: the MoE gate and plain version
# ---------------------------------------------------------------------------


def _qstack(rng, K, N, qtype=GGMLType.Q8_0):
    w = rng.standard_normal((N, K), dtype=np.float32) * 0.05
    qt = jqmm.pack_gguf_tensor(quantize(w, qtype), qtype, (N, K))
    st = lambda a: None if a is None else jnp.stack([a] * L)  # noqa: E731
    return jqmm.QuantTensor(q=st(qt.q), s=st(qt.s), m=st(qt.m), fmt=qt.fmt,
                            group=qt.group, shape=qt.shape)


def _estack(rng, qtype, E, N, K, **pad):
    raw = (rng.standard_normal((E * N, K), dtype=np.float32) * 0.05)
    qt = jqmm.pack_gguf_experts(quantize(raw, qtype), qtype, (E, N, K), **pad)
    st = lambda a: None if a is None else jnp.stack([a] * L)  # noqa: E731
    return jqmm.QuantTensor(q=st(qt.q), s=st(qt.s), m=st(qt.m), fmt=qt.fmt,
                            group=qt.group, shape=qt.shape)


def moe_model(qtype=GGMLType.Q8_0, E=8, EF=256, Dm=D, hq=HQ, pad=False, seed=29, **cfg_kw):
    """The JAX decode-stream MoE test's stack: Q8_0 attention, stacked
    experts (Q8_0 int8, or Q4_K nib4c with the FF padded as the loader
    pads it), a random f32 router."""
    rng = np.random.default_rng(seed)
    ek = dict(pad_n=True) if pad else {}
    dk = dict(pad_k=True) if pad else {}
    layers = j_fuse({
        "attn_norm": jnp.ones((L, Dm), jnp.float32) * 1.1,
        "ffn_norm": jnp.ones((L, Dm), jnp.float32) * 0.9,
        "wq": _qstack(rng, Dm, hq * DH), "wk": _qstack(rng, Dm, HKV * DH),
        "wv": _qstack(rng, Dm, HKV * DH), "wo": _qstack(rng, hq * DH, Dm),
        "moe_gate_inp": jnp.asarray(rng.standard_normal((L, Dm, E)) * 0.3, jnp.float32),
        "moe_gate": _estack(rng, qtype, E, EF, Dm, **ek),
        "moe_up": _estack(rng, qtype, E, EF, Dm, **ek),
        "moe_down": _estack(rng, qtype, E, Dm, EF, **dk)})
    head = rng.standard_normal((V, Dm), dtype=np.float32) * 0.05
    params = {"tok_emb": jnp.asarray(rng.standard_normal((V, Dm)) * 0.1, jnp.bfloat16),
              "out_norm": jnp.ones(Dm, jnp.float32),
              "lm_head": jqmm.pack_gguf_tensor(quantize(head, GGMLType.Q8_0),
                                               GGMLType.Q8_0, (V, Dm)),
              "layers": layers}
    kw = dict(arch="llama", n_layers=L, n_embd=Dm, n_heads=hq, n_kv_heads=HKV,
              head_dim=DH, n_ff=512, n_vocab=V, n_ctx_train=S, n_experts=E,
              n_experts_used=2, expert_ff=EF, expert_weights_norm=True)
    kw.update(cfg_kw)
    return JConfig(**kw), params


def port_cfg(jcfg) -> ModelConfig:
    names = [f.name for f in dataclasses.fields(ModelConfig) if f.name != "rope_scaling"]
    return ModelConfig(**{n: getattr(jcfg, n) for n in names})


def _port(jcfg, jparams):
    cfg = port_cfg(jcfg)
    return cfg, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)


def _gates(jcfg, jparams, B=1):
    cfg, params = _port(jcfg, jparams)
    jkv = JKV.create(jcfg, batch=B, max_seq=S, dtype=jnp.bfloat16)
    kv = KVCache.create(cfg, B, S, torch.bfloat16)
    return ((j_stream_ok(jparams, jcfg, jkv, B, 1), k6._stream_ok(params, cfg, kv, B, 1)),
            (j_moe_ok(jparams["layers"], jcfg), k6._moe_stream_ok(params["layers"][0], cfg)))


@pytest.mark.parametrize("case", ["plain", "B2", "sigmoid", "gating3", "router_bias",
                                  "shexp_unfused", "topk9", "nib4c_padded"])
def test_moe_stream_gate_matches_jax(case):
    """The K6 MoE gate decides as the JAX gate on these params."""
    kw, B, extra = {}, 1, {}
    if case == "sigmoid":
        kw["expert_gating_func"] = 2
    elif case == "gating3":
        kw["expert_gating_func"] = 3
    elif case == "topk9":
        kw.update(n_experts_used=9, n_experts=16)
    jcfg, jp = moe_model(E=kw.get("n_experts", 8), **kw,
                         **({"qtype": GGMLType.Q4_K, "EF": 384, "pad": True, "Dm": 512,
                             "hq": 4} if case == "nib4c_padded" else {}))
    if case == "B2":
        B = 2
    elif case == "router_bias":
        extra["moe_gate_inp_b"] = jnp.zeros((L, jcfg.n_experts), jnp.float32)
    elif case == "shexp_unfused":
        rng = np.random.default_rng(1)
        extra.update(shexp_gate=_qstack(rng, D, 512), shexp_up=_qstack(rng, D, 512),
                     shexp_down=_qstack(rng, 512, D))
    jp = dict(jp, layers={**jp["layers"], **extra})
    (js, ts), (jm, tm) = _gates(jcfg, jp, B)
    assert ts == js and tm == jm
    assert js == (case in ("plain", "sigmoid", "nib4c_padded"))


def test_moe_stream_gate_refuses_the_shared_expert():
    """A fused shared expert (qwen2moe) passes the JAX gate and, since K6's
    shared-expert mode is ported, the port's; a shared expert whose down
    half is missing is refused by both."""
    jcfg, jp = moe_model()
    rng = np.random.default_rng(2)
    gu = _qstack(rng, D, 1024)
    full = dict(jp, layers={**jp["layers"], "shexp_gateup_fused": gu,
                            "shexp_down": _qstack(rng, 512, D)})
    (js, ts), _ = _gates(jcfg, full)
    assert js and ts
    half = dict(jp, layers={**jp["layers"], "shexp_gateup_fused": gu})
    (js, ts), _ = _gates(jcfg, half)
    assert not js and not ts


@functools.lru_cache(maxsize=None)
def _j_step(jcfg):
    return jax.jit(lambda p, x, kv: j_k6(p, jcfg, x, kv, interpret=True))


def lockstep(jcfg, jparams, n_prompt=7, steps=2, logit_tol=2e-2, kv_tol=3e-2, seed=7):
    """Prefill (the JAX forward), then decode ``steps`` tokens through the
    JAX kernel in interpret mode and the port's K6 plain version from the
    same cache; logits, cache and the expert ids compared every step."""
    cfg, params = _port(jcfg, jparams)
    rng = np.random.default_rng(seed)
    jkv = JKV.create(jcfg, batch=1, max_seq=S, dtype=jnp.bfloat16)
    toks = rng.integers(0, V, (1, n_prompt)).astype(np.int32)
    _, jkv = j_forward(jparams, jcfg, jnp.asarray(toks), jkv)
    kv = KVCache(k=_t(jkv.k), v=_t(jkv.v), n_past=torch.tensor([n_prompt], dtype=torch.int32))
    assert j_stream_ok(jparams, jcfg, jkv, 1, 1) and k6._stream_ok(params, cfg, kv, 1, 1)
    tok = np.array([[5]], np.int32)
    for _ in range(steps):
        jx2, jk, jv = _j_step(jcfg)(jparams, jparams["tok_emb"][tok], jkv)
        jkv = JKV(k=jk, v=jv, n_past=jkv.n_past + 1)
        ids = []
        x2 = k6.decode_layers_plain(params, cfg, params["tok_emb"][torch.from_numpy(tok)],
                                    kv, ids_out=ids)
        kv.n_past += 1
        assert len(ids) == L and all(i.shape == (1, 2) for i in ids)
        jl = _np(jqmm.linear(j_rms_norm(jx2, jparams["out_norm"], jcfg.rms_eps),
                             jparams["lm_head"]))
        tl = _np(tq.linear(rms_norm(x2, params["out_norm"], cfg.rms_eps), params["lm_head"]))
        np.testing.assert_allclose(tl, jl, rtol=logit_tol, atol=logit_tol)
        np.testing.assert_allclose(_np(kv.k), _np(jkv.k), rtol=kv_tol, atol=kv_tol)
        np.testing.assert_allclose(_np(kv.v), _np(jkv.v), rtol=kv_tol, atol=kv_tol)
        tok = np.argmax(jl[:, 0], -1).reshape(1, 1).astype(np.int32)


@pytest.mark.parametrize("gating,wnorm", [(1, True), (2, True), (1, False)])
def test_k6_moe_plain_matches_jax_q8_0(gating, wnorm):
    jcfg, jp = moe_model(expert_gating_func=gating, expert_weights_norm=wnorm)
    lockstep(jcfg, jp)


def test_k6_moe_plain_matches_jax_nib4c_padded():
    """nib4c experts with the FF padded 384 -> 512 (the JAX test's shape)."""
    jcfg, jp = moe_model(GGMLType.Q4_K, E=4, EF=384, Dm=512, hq=4, pad=True, seed=31)
    lockstep(jcfg, jp, logit_tol=8e-2, kv_tol=6e-2)


def test_k6_moe_plain_matches_port_layer_loop():
    """The plain K6 (router on the f32 h2) against the port's per-layer loop
    (router on the bf16 h), as the JAX MoE kernel test holds its kernel to
    its scan: a 7-token prefill through the loop, then 3 decode steps from
    the same cache both ways, logits allclose at 2e-2."""
    from llama_cpp_gfx906_tpu_torch.models.llama import forward, layers_forward

    jcfg, jp = moe_model()
    cfg, params = _port(jcfg, jp)
    kv = KVCache.create(cfg, 1, S, torch.bfloat16)
    forward(params, cfg, torch.from_numpy(np.random.default_rng(3).integers(0, V, (1, 7))), kv)
    tok = 5
    for _ in range(3):
        logits = []
        for fn in (k6.fused_decode_step_streamed_plain, layers_forward):
            c = KVCache(k=kv.k.clone(), v=kv.v.clone(), n_past=kv.n_past.clone())
            h = fn(params, cfg, params["tok_emb"][torch.tensor([[tok]])], c)
            logits.append(_np(tq.linear(rms_norm(h, params["out_norm"], cfg.rms_eps),
                                        params["lm_head"])))
        np.testing.assert_allclose(logits[0], logits[1], rtol=2e-2, atol=2e-2)
        forward(params, cfg, torch.tensor([[tok]]), kv)
        tok = int(np.argmax(logits[1]))


def test_layer_table_split_v_moe(tiny_moe):
    """A Q4_K_M MoE layer (q|k fused, a Q6_K v apart, no dense FFN): the
    v and o slots hold v and o, the gate|up and down slots are empty."""
    te = Engine.from_gguf(tiny_moe["tiny-moe"], max_seq=64, device="cpu")
    table = layer_table(te.params, te.cfg)
    for li, p in enumerate(te.params["layers"]):
        row = table[li].tolist()
        assert row[0] == p["wqk_fused"].q.data_ptr() and row[5] == p["wv"].q.data_ptr()
        assert row[10] == p["wo"].q.data_ptr() and row[15:25] == [0] * 10
        assert row[29] == p["moe_gate"].q.data_ptr()


def test_layer_table_expert_words():
    jcfg, jp = moe_model(GGMLType.Q4_K, E=4, EF=384, Dm=512, hq=4, pad=True)
    cfg, params = _port(jcfg, jp)
    table = layer_table(params, cfg)
    assert table.shape == (L, k6.TABLE_W)
    for li, p in enumerate(params["layers"]):
        row = table[li].tolist()
        assert row[0] == p["wqkv_fused"].q.data_ptr() and row[15:25] == [0] * 10
        assert row[28] == p["moe_gate_inp"].data_ptr()  # E = 4: no pad copy
        for t, k in enumerate(k6.EXPERT_KEYS):
            qt = p[k]
            assert row[29 + 5 * t:34 + 5 * t] == [
                qt.q.data_ptr(), qt.s.data_ptr(), qt.m.data_ptr(),
                qt.q[1].data_ptr() - qt.q[0].data_ptr(),
                qt.s[1].data_ptr() - qt.s[0].data_ptr()]


# ---------------------------------------------------------------------------
# the whole slice: tiny-moe through both engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_moe(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_moe")
    return {p: write_synth(str(d / f"{p}.gguf"), p, seed=0)
            for p in ("tiny-moe", "tiny-moe-q8_0")}


@pytest.mark.parametrize("preset", ["tiny-moe", "tiny-moe-q8_0"])
def test_tiny_moe_engines_match_jax(tiny_moe, preset):
    """Prefill (the dense all-experts path) and 8 decode steps (the routed
    path; tiny layers take the JAX forward's K7 branch, whose gate refuses
    MoE, so both decode through the layer loop) against the JAX engine."""
    path = tiny_moe[preset]
    je = JEngine.from_gguf(path, max_seq=64, dtype=jnp.float32)
    te = Engine.from_gguf(path, max_seq=64, dtype=torch.float32, device="cpu")
    assert te.cfg.n_experts == 4 and te.cfg.n_experts_used == 2
    assert te.cfg.expert_weights_norm and te.cfg.rope_base == 1e6
    assert layer_bytes(te.params) <= 6 * 2**20  # experts left out
    ids = je.tokenizer.tokenize("the quick brown fox jumps", add_special=True,
                                parse_special=True)
    assert len(ids) > 8
    je.reset()
    te.reset()
    a, b = je.prefill(ids), te.prefill(ids)
    assert _rel(b, a) < 1e-2
    tok = int(np.argmax(a))
    for _ in range(8):
        a, b = je.decode_one(tok), te.decode_one(tok)
        err = _rel(b, a)
        assert err < 1e-2
        top2 = np.sort(a)[-2:]
        if top2[1] - top2[0] > 2 * err * np.abs(a).max():
            assert int(np.argmax(b)) == int(np.argmax(a))
        tok = int(np.argmax(a))


def test_tiny_moe_batched_matches_single_stream(tiny_moe):
    """BatchedEngine at 2 slots (a prompt each, prefilled in one chunk
    through the dense path as the single stream prefills it; the batched
    decode step routes 2 tokens) gives each prompt the single-stream
    engine's greedy tokens."""
    path = tiny_moe["tiny-moe-q8_0"]
    single = Engine.from_gguf(path, max_seq=64, dtype=torch.float32, device="cpu")
    be = BatchedEngine.from_gguf(path, dtype=torch.float32, device="cpu", n_slots=2,
                                 max_seq=64, n_chunk=64)
    prompts = ["the quick brown fox", "tok5 tok7 jumps over"]
    want = [single.generate(p, n_predict=8, stop_on_eog=False)[1] for p in prompts]
    slots = [be.add_request(be.tokenizer.tokenize(p, add_special=True, parse_special=True),
                            8, SamplerConfig(temp=0.0)) for p in prompts]
    got = {s.id: [] for s in slots}
    while any(s.stop_reason is None for s in slots):
        for s, t, _ in be.step():
            got[s.id].append(t)
    assert [got[s.id] for s in slots] == want
