"""Port parity: the q8 KV cache (llama_cpp_gfx906_tpu_torch.ops.kv_quant)
and the K3/K4 modes that read it, K3's shared-prefix mode, and the routing
that keeps the decode megakernels away from both, against the JAX package
on the CPU.

Quantization is byte-equal.  The K3 plain paths (the einsum over rows
dequantized to f32) are held to the JAX ``flash_decode`` in interpret mode
at its test's bound, max error / max |ref| < 2e-2 (tests/test_flash_decode.py:
56-58: the JAX kernel rounds q and p to bf16); K4's int8 plain path to the
JAX ``flash_attention`` in interpret mode at rtol = atol = 2e-2
(tests/test_flash_attention.py:135).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_cpp_gfx906_tpu.models.llama import KVCache as JKV
from llama_cpp_gfx906_tpu.ops import attention as jatt
from llama_cpp_gfx906_tpu.ops import kv_quant as jkq
from llama_cpp_gfx906_tpu.ops.decode_step import _fused_ok as j_fused_ok
from llama_cpp_gfx906_tpu.ops.decode_stream import _stream_ok as j_stream_ok
from llama_cpp_gfx906_tpu.ops.flash_attention import flash_attention as j_flash_attention
from llama_cpp_gfx906_tpu.ops.flash_decode import flash_decode as j_flash_decode
from llama_cpp_gfx906_tpu.ops.rope import rope_frequencies, rope_shift_rows as j_shift
from llama_cpp_gfx906_tpu.runtime.engine import Engine as JEngine
from llama_cpp_gfx906_tpu_torch.models import llama as tllama
from llama_cpp_gfx906_tpu_torch.models.llama import KVCache
from llama_cpp_gfx906_tpu_torch.ops import attention as tatt
from llama_cpp_gfx906_tpu_torch.ops import decode_step as k7
from llama_cpp_gfx906_tpu_torch.ops import decode_stream as k6
from llama_cpp_gfx906_tpu_torch.ops import kv_quant as tkq
from llama_cpp_gfx906_tpu_torch.ops.flash_attention import flash_attention
from llama_cpp_gfx906_tpu_torch.ops.flash_decode import flash_decode
from llama_cpp_gfx906_tpu_torch.ops.rope import inv_freq_for, rope_shift_rows
from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINYDOC = os.path.join(ROOT, "tests", "fixtures", "tinydoc-byte.f16.gguf")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a))


def rel_err(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max() / (np.abs(np.asarray(ref)).max() + 1e-6)


def rows(seed, shape, scale=0.7):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    x[..., 0, :] = 0.0  # an all-zero row: scale 0, values 0
    return x


@pytest.mark.parametrize("shape", [(2, 5, 4, 16), (1, 7, 2, 64), (3, 2, 8, 128)])
def test_quantize_and_dequantize_byte_equal(shape):
    x = rows(1, shape) * 3
    j, p = jkq.quantize_rows(jnp.asarray(x)), tkq.quantize_rows(t(x))
    assert p.q.dtype == torch.int8 and p.s.shape == (*shape[:-1], 1)
    assert p.q.numpy().tobytes() == np.asarray(j.q).tobytes()
    assert p.s.numpy().tobytes() == np.asarray(j.s).tobytes()
    back = tkq.dequantize_rows(p, torch.float32).numpy()
    assert back.tobytes() == np.asarray(jkq.dequantize_rows(j, jnp.float32)).tobytes()
    # ties round half to even, as jnp.round does
    half = np.zeros((1, 1, 1, 4), np.float32)
    half[..., :] = [127.0, 0.5, 1.5, -2.5]
    assert tkq.quantize_rows(t(half)).q.flatten().tolist() == [127, 0, 2, -2]


def test_insert_quant_and_take_rows_byte_equal():
    B, S, H, D, T = 2, 12, 2, 16, 3
    cache = rows(2, (B, S, H, D))
    new = rows(3, (B, T, H, D))
    n_past = np.asarray([4, 9], np.int32)
    jc = jkq.insert_quant(jkq.quantize_rows(jnp.asarray(cache)), jnp.asarray(new),
                          jnp.asarray(n_past))
    pc = tkq.quantize_rows(t(cache))
    tkq.insert_quant(pc, t(new), t(n_past))  # in place
    for a, b in ((pc.q, jc.q), (pc.s, jc.s)):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    src = np.asarray([0, 1, 5, 6, 7, 11, 11, 2, 3, 4, 8, 9], np.int32)
    jt = jkq.take_rows(jc, jnp.asarray(src), axis=1)
    pt = tkq.take_rows(pc, t(src).long(), axis=1)
    for a, b in ((pt.q, jt.q), (pt.s, jt.s)):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    # indexing keeps both planes as views
    layer = pc[:, 1:2]
    assert layer.q.data_ptr() == pc.q[:, 1:2].data_ptr() and layer.shape == (B, 1, H, D)


def decode_case(seed, B=2, T=1, Hq=8, Hkv=2, D=64, S=256, S0=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, T, Hq, D)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((B, S, Hkv, D)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((B, S, Hkv, D)) * 0.3).astype(np.float32)
    n_past = rng.integers(3, S - T - 1, size=B).astype(np.int32)
    sh = [(rng.standard_normal((1, S0, Hkv, D)) * 0.3).astype(np.float32)
          for _ in range(2)] if S0 else [None, None]
    return q, k, v, n_past, sh, rng.standard_normal(Hq).astype(np.float32)


K3_CASES = [
    dict(mode="int8"), dict(mode="int8", T=4, window=32), dict(mode="int8", sinks=True, T=3),
    dict(mode="int8", D=128, Hq=32, Hkv=8),
    dict(mode="shared", S0=40, softcap=20.0), dict(mode="shared", S0=130, T=4, window=24,
                                                   sinks=True),
    dict(mode="both", S0=64, T=2, window=48),
    dict(mode="both", S0=33, D=128, Hq=32, Hkv=8, sinks=True),
]


@pytest.mark.parametrize("case", K3_CASES)
def test_k3_quant_and_shared_plain_match_jax(case):
    """K3's int8-KV mode, shared-prefix mode and both together (int8 own
    rows, f32 shared rows), as tests/test_flash_decode.py:250 combines them."""
    case = dict(case)
    mode, window = case.pop("mode"), case.pop("window", 0)
    softcap, use_sinks = case.pop("softcap", 0.0), case.pop("sinks", False)
    q, k, v, n_past, (shk, shv), sinks = decode_case(5, **case)
    scale = q.shape[-1] ** -0.5
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    pk, pv = t(k), t(v)
    if mode in ("int8", "both"):
        jk, jv = jkq.quantize_rows(jk), jkq.quantize_rows(jv)
        pk, pv = tkq.quantize_rows(pk), tkq.quantize_rows(pv)
    kw = dict(sliding_window=window, logit_softcap=softcap)
    jshared = {} if shk is None else dict(shared_k=jnp.asarray(shk), shared_v=jnp.asarray(shv))
    pshared = {} if shk is None else dict(shared_k=t(shk), shared_v=t(shv))
    ref = j_flash_decode(jnp.asarray(q), jk, jv, jnp.asarray(n_past), scale,
                         sinks=jnp.asarray(sinks) if use_sinks else None,
                         interpret=True, **kw, **jshared)
    got = flash_decode(t(q), pk, pv, t(n_past), scale, window, softcap,
                       t(sinks) if use_sinks else None, **pshared)
    assert got.shape == q.shape
    assert rel_err(got.numpy(), ref) < 2e-2


@pytest.mark.parametrize("case", [dict(), dict(n_past=(0, 37), T=100, S=200),
                                  dict(window=32, sinks=True),
                                  dict(Hq=8, Hkv=2, D=128, softcap=30.0)])
def test_k4_int8_plain_matches_jax(case):
    case = dict(case)
    window, softcap = case.pop("window", 0), case.pop("softcap", 0.0)
    use_sinks, n_past = case.pop("sinks", False), case.pop("n_past", (0, 64))
    T, S = case.pop("T", 128), case.pop("S", 256)
    Hq, Hkv, D = case.pop("Hq", 4), case.pop("Hkv", 2), case.pop("D", 64)
    rng = np.random.default_rng(6)
    q = (rng.standard_normal((2, T, Hq, D)) * 0.3).astype(np.float32)
    k, v = rows(7, (2, S, Hkv, D), 0.3), rows(8, (2, S, Hkv, D), 0.3)
    sinks = rng.standard_normal(Hq).astype(np.float32) if use_sinks else None
    kq, vq = tkq.quantize_rows(t(k)), tkq.quantize_rows(t(v))
    scale = D ** -0.5
    ref = j_flash_attention(
        jnp.asarray(q), jnp.asarray(kq.q.numpy()), jnp.asarray(vq.q.numpy()),
        jnp.asarray(np.asarray(n_past, np.int32)), scale, sliding_window=window,
        logit_softcap=softcap, sinks=None if sinks is None else jnp.asarray(sinks),
        k_scales=jnp.asarray(kq.s[..., 0].numpy()), v_scales=jnp.asarray(vq.s[..., 0].numpy()),
        block_q=64, block_k=64, interpret=True)
    got = flash_attention(t(q), kq.q, vq.q, t(np.asarray(n_past, np.int32)), scale, window,
                          softcap, None if sinks is None else t(sinks),
                          k_scales=kq.s[..., 0], v_scales=vq.s[..., 0])
    assert got.dtype == torch.float32  # q's dtype (the JAX kernel returns bf16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("T,S0", [(1, 0), (3, 0), (100, 0), (2, 24), (100, 24)])
def test_mha_with_q8_cache_matches_jax(T, S0):
    """mha_with_cache over a QuantKV cache (with a shared segment or not):
    the same int8 planes and scales after the insert, the same output as the
    JAX einsum path (T = 100: G*T > 128, K4's int8 mode, or the einsum with
    a shared segment)."""
    q, k, v, n_past, (shk, shv), _ = decode_case(9, T=T, Hq=4, Hkv=2, S=160, S0=S0)
    n_past = np.minimum(n_past, 160 - T - 1).astype(np.int32)
    rng = np.random.default_rng(10)
    k_new, v_new = ((rng.standard_normal(q.shape[:2] + k.shape[2:]) * 0.3).astype(np.float32)
                    for _ in range(2))
    jshared = {} if shk is None else dict(shared_k=jnp.asarray(shk), shared_v=jnp.asarray(shv))
    pshared = {} if shk is None else dict(shared_k=t(shk), shared_v=t(shv))
    jk, jv = jkq.quantize_rows(jnp.asarray(k)), jkq.quantize_rows(jnp.asarray(v))
    ref, jk2, jv2 = jatt.mha_with_cache(jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
                                        jk, jv, jnp.asarray(n_past), 0.125, **jshared)
    pk, pv = tkq.quantize_rows(t(k)), tkq.quantize_rows(t(v))
    got, pk2, pv2 = tatt.mha_with_cache(t(q), t(k_new), t(v_new), pk, pv, t(n_past), 0.125,
                                        **pshared)
    assert pk2 is pk and pv2 is pv
    for a, b in ((pk.q, jk2.q), (pk.s, jk2.s), (pv.q, jv2.q), (pv.s, jv2.s)):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-3, atol=2e-3)


def test_rope_shift_rows_matches_jax():
    from llama_cpp_gfx906_tpu.models.config import ModelConfig as JConfig
    from llama_cpp_gfx906_tpu_torch.models.config import ModelConfig

    kw = dict(arch="llama", n_layers=2, n_embd=64, n_heads=4, n_kv_heads=2, head_dim=16,
              n_ff=64, n_vocab=32, n_ctx_train=64, rope_base=10000.0)
    x = rows(11, (2, 1, 20, 2, 16))
    deltas = np.where(np.arange(20) >= 6, -5, 0).astype(np.int32)[None]
    for interleaved in (True, False):
        ref = j_shift(jnp.asarray(x), jnp.asarray(deltas),
                      jnp.asarray(rope_frequencies(JConfig(**kw))), interleaved)
        got = rope_shift_rows(t(x), t(deltas), inv_freq_for(ModelConfig(**kw), "cpu"),
                              interleaved)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
        assert torch.equal(got[:, :, :6], t(x)[:, :, :6])  # delta 0 rows as they were


@pytest.fixture(scope="module")
def gate_model():
    from tests.test_torch_decode_stream import j_cfg, port_cfg, q8_params
    from llama_cpp_gfx906_tpu_torch.runtime.weights import params_from_jax

    jp = q8_params(np.random.default_rng(4))
    jcfg = j_cfg()
    cfg = port_cfg(jcfg)
    return jp, jcfg, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg), cfg


@pytest.mark.parametrize("kind", ["q8", "shared", "slot_view"])
@pytest.mark.parametrize("gate", ["k6", "k7"])
def test_decode_kernel_gates_refuse_q8_and_shared(gate_model, kind, gate):
    """The K6/K7 gates refuse a q8 cache and a shared segment first, as the
    JAX gates do (ops/decode_stream.py:790-793), and a slot's view of a
    batched cache (the prefill's T = 1 chunk)."""
    jp, jcfg, params, cfg = gate_model
    B, S = 1, 256
    jfn, tfn = (j_stream_ok, k6._stream_ok) if gate == "k6" else (j_fused_ok, k7._fused_ok)
    if kind == "slot_view":
        big = KVCache.create(cfg, 3, S, torch.bfloat16)
        kv = KVCache(k=big.k[:, 1:2], v=big.v[:, 1:2], n_past=big.n_past[:1])
        assert not tfn(params, cfg, kv, B, 1)
        return
    jkv = JKV.create(jcfg, 1, S, "q8" if kind == "q8" else jnp.bfloat16)
    kv = KVCache.create(cfg, 1, S, "q8" if kind == "q8" else torch.bfloat16)
    if kind == "shared":
        L, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        jkv = JKV(jkv.k, jkv.v, jkv.n_past, shared_k=jnp.zeros((L, 1, 8, Hkv, Dh)),
                  shared_v=jnp.zeros((L, 1, 8, Hkv, Dh)))
        kv.shared_k = kv.shared_v = torch.zeros((L, 1, 8, Hkv, Dh))
    assert jfn(jp, jcfg, jkv, B, 1) is False
    assert tfn(params, cfg, kv, B, 1) is False


def test_decode_route_key_sees_cache_kind_and_shared_segment(gate_model, monkeypatch):
    """decode_route caches its choice per cache: a cache that gains a shared
    segment, or is q8, must be routed anew (and refused by K6), not sent to
    the route found for the plain cache.  The card is stood in for by
    routing CPU tensors."""
    _, _, params, cfg = gate_model
    monkeypatch.setattr(tllama, "_on_card", lambda kv: True)
    monkeypatch.setattr(tllama, "layer_bytes", lambda p: 1 << 30)  # K6's side
    monkeypatch.setattr("llama_cpp_gfx906_tpu_torch.runtime.weights.layer_table",
                        lambda p, c: None)
    params.__dict__.pop("_decode_routes", None)
    kv = KVCache.create(cfg, 1, 256, torch.bfloat16)
    assert tllama.decode_route(params, cfg, kv) == "k6"
    L, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    shared = KVCache(kv.k, kv.v, kv.n_past, shared_k=torch.zeros((L, 1, 8, Hkv, Dh)),
                     shared_v=torch.zeros((L, 1, 8, Hkv, Dh)))
    assert tllama.decode_route(params, cfg, shared) is None
    assert tllama.decode_route(params, cfg, KVCache.create(cfg, 1, 256, "q8")) is None
    assert tllama.decode_route(params, cfg, kv) == "k6"
    params.__dict__.pop("_decode_routes", None)


def test_engine_q8_cache_matches_jax():
    """Engine.from_gguf(kv_cache_dtype="q8"): the same int8 planes after the
    prefill, the same logits and greedy tokens as the JAX engine's q8 cache
    (after tests/test_kv_quant.py:55)."""
    je = JEngine.from_gguf(TINYDOC, max_seq=64, dtype=jnp.float32, kv_cache_dtype="q8")
    te = Engine.from_gguf(TINYDOC, max_seq=64, dtype=torch.float32, device="cpu",
                          kv_cache_dtype="q8")
    assert isinstance(te.kv.k, tkq.QuantKV) and te.kv.k.q.dtype == torch.int8
    ids = te.tokenizer.tokenize("quant", add_special=True, parse_special=True)
    a, b = je.prefill(ids), te.prefill(ids)
    assert rel_err(b, a) < 1e-4
    n = len(ids)
    assert np.array_equal(te.kv.k.q[:, 0, :n].numpy(), np.asarray(je.kv.k.q)[:, 0, :n])
    want = je.generate("# ", 12)[1]
    assert te.generate("# ", 12)[1] == want
    # the fused loop takes the per-layer route over the q8 cache
    assert te.generate_fused("# ", n_predict=12, stop_on_eog=False, chunk=4)[1] == want


def test_counted_modes_name_counts_and_device_slots():
    """A wrapper's registration names its mode counts and its device-side
    count slots in one place: K3's flags (int8, shared) are bits 0 and 1 of
    its slot, K4's int8 bit 0; ``kernels.count`` adds to the kernel and to
    the mode its flags spell."""
    from llama_cpp_gfx906_tpu_torch import kernels
    from llama_cpp_gfx906_tpu_torch.ops.flash_attention import flash_attention
    from llama_cpp_gfx906_tpu_torch.ops.flash_decode import flash_decode

    assert {s: kernels._SLOTS["flash_decode", s] for s in range(4)} == {
        0: ("flash_decode",), 1: ("flash_decode", "flash_decode_int8"),
        2: ("flash_decode", "flash_decode_shared"),
        3: ("flash_decode", "flash_decode_int8_shared")}
    assert kernels._SLOTS["flash_attention", 1] == ("flash_attention", "flash_attention_int8")
    assert kernels._SLOTS["decode_stream", 5] == ("decode_step",)
    assert kernels._SLOTS["decode_stream", 6] == ("decode_step", "decode_step_gemma")
    assert kernels._SLOTS["decode_stream", 1] == ("decode_stream",)
    assert kernels._SLOTS["decode_stream", 3] == ("decode_stream", "decode_stream_gemma")
    saved = kernels.counts()
    try:
        for flags in ((True, False), (False, True), (True, True), (False, False)):
            kernels.count(flash_decode, *flags)
        kernels.count(flash_attention, True)
        got = {k: v - saved[k] for k, v in kernels.counts().items() if v != saved[k]}
    finally:
        kernels.set_counts(saved)
    assert got == dict(flash_decode=4, flash_decode_int8=1, flash_decode_shared=1,
                       flash_decode_int8_shared=1, flash_attention=1,
                       flash_attention_int8=1)


def test_device_counts_name_each_slot(monkeypatch):
    """The kernels' device-side launch counts reach the wrappers' count
    names slot by slot: K3's four mode slots add to ``flash_decode`` and to
    their mode, K7 and K6 share one library."""
    from llama_cpp_gfx906_tpu_torch import kernels

    class Lib:
        def __init__(self, vals):
            self.vals = vals

        def lcg_device_counts(self, out):
            for i, v in enumerate(self.vals):
                out[i] = v
            return 0

    monkeypatch.setattr(kernels, "_libs", {"flash_decode": Lib([5, 2, 3, 1]),
                                           "flash_attention": Lib([4, 6]),
                                           "decode_stream": Lib([0, 9, 0, 0, 0, 7])})
    got = {k: v for k, v in kernels.device_counts().items() if v}
    assert got == dict(flash_decode=11, flash_decode_int8=2, flash_decode_shared=3,
                       flash_decode_int8_shared=1, flash_attention=10,
                       flash_attention_int8=6, decode_step=7, decode_stream=9)
