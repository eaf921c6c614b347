"""Port parity: attention (llama_cpp_gfx906_tpu_torch.ops.attention,
flash_decode, flash_attention) against the JAX package.

The K3/K4 plain versions (what the wrappers run for CPU tensors) are held
against the JAX kernels in interpret mode and the JAX einsum oracle at f32:
2e-3 wherever the JAX side computes in f32 (the einsum, flash_attention);
2e-2 against the JAX flash_decode, which rounds q and p to bf16 inside
(tests/test_flash_decode.py uses the same bound).  mha_with_cache must
return the same output and the same updated caches.  The kernels are held
against the plain versions on a card in tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama_cpp_gfx906_tpu.ops import attention as jatt
from llama_cpp_gfx906_tpu.ops.flash_attention import flash_attention as j_flash_attention
from llama_cpp_gfx906_tpu.ops.flash_decode import flash_decode as j_flash_decode
from llama_cpp_gfx906_tpu_torch.ops import attention as tatt
from llama_cpp_gfx906_tpu_torch.ops.flash_attention import flash_attention
from llama_cpp_gfx906_tpu_torch.ops.flash_decode import flash_decode


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small CPU ops, fastest on one thread; under
    pytest-xdist, torch's default of one thread per core in every worker
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_case(seed, B=2, T=1, Hq=4, Hkv=2, D=64, S=256, n_past=None):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, T, Hq, D)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((B, S, Hkv, D)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((B, S, Hkv, D)) * 0.3).astype(np.float32)
    if n_past is None:
        n_past = rng.integers(3, S - T - 1, size=B)
    sinks = rng.standard_normal(Hq).astype(np.float32)
    return q, k, v, np.asarray(n_past, np.int32), sinks


def rel_err(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max() / (np.abs(np.asarray(ref)).max() + 1e-6)


def t(a):
    return torch.from_numpy(np.array(a))


DECODE_CASES = [
    dict(),
    dict(T=4),
    dict(Hq=4, Hkv=4),
    dict(window=32),
    dict(softcap=30.0),
    dict(sinks=True),
    dict(sinks=True, window=16, T=3),
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_flash_decode_plain_matches_jax(case):
    case = dict(case)
    window, softcap = case.pop("window", 0), case.pop("softcap", 0.0)
    use_sinks = case.pop("sinks", False)
    q, k, v, n_past, sinks = make_case(1, **case)
    sinks = sinks if use_sinks else None
    scale = q.shape[-1] ** -0.5
    got = flash_decode(t(q), t(k), t(v), t(n_past), scale, window, softcap,
                       t(sinks) if sinks is not None else None).numpy()
    jargs = dict(sliding_window=window, logit_softcap=softcap,
                 sinks=jnp.asarray(sinks) if sinks is not None else None)
    kern = j_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(n_past), scale, interpret=True, **jargs)
    # the einsum oracle re-inserts the rows the cache already holds
    rows = (n_past[:, None] + np.arange(q.shape[1]))[:, :, None, None]
    einsum, _, _ = jatt.mha_with_cache(
        jnp.asarray(q), jnp.asarray(np.take_along_axis(k, rows, 1)),
        jnp.asarray(np.take_along_axis(v, rows, 1)), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(n_past), scale, **jargs)
    assert rel_err(got, einsum) < 2e-3
    assert rel_err(got, kern) < 2e-2


FLASH_CASES = [
    dict(),
    dict(Hq=4, Hkv=4),
    dict(T=100, S=200),
    dict(n_past=(32, 5)),
    dict(window=32),
    dict(softcap=30.0),
    dict(sinks=True),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_plain_matches_jax(case):
    case = dict(case)
    window, softcap = case.pop("window", 0), case.pop("softcap", 0.0)
    use_sinks = case.pop("sinks", False)
    case.setdefault("T", 128)
    case.setdefault("n_past", (0, 64))
    q, k, v, n_past, sinks = make_case(2, **case)
    sinks = sinks if use_sinks else None
    scale = q.shape[-1] ** -0.5
    got = flash_attention(t(q), t(k), t(v), t(n_past), scale, window, softcap,
                          t(sinks) if sinks is not None else None).numpy()
    ref = j_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(n_past), scale,
        sliding_window=window, logit_softcap=softcap,
        sinks=jnp.asarray(sinks) if sinks is not None else None,
        block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-3, atol=2e-3)


MHA_CASES = [
    dict(T=1),
    dict(T=5, window=3),
    dict(T=100, S=160, n_past=(0, 20)),   # G*T > 128: the K4 wrapper
    dict(T=2, sinks=True, softcap=20.0),
    dict(T=3, alibi=True),
    dict(T=2, self_extend=True),
    dict(T=2, shared=8),
]


@pytest.mark.parametrize("case", MHA_CASES)
def test_mha_with_cache_matches_jax(case):
    case = dict(case)
    window, softcap = case.pop("window", 0), case.pop("softcap", 0.0)
    use_sinks, alibi = case.pop("sinks", False), case.pop("alibi", False)
    self_extend, n_sh = case.pop("self_extend", False), case.pop("shared", 0)
    q, k, v, n_past, sinks = make_case(3, **case)
    B, T, Hq, D = q.shape
    Hkv, S = k.shape[2], k.shape[1]
    rng = np.random.default_rng(4)
    k_new = (rng.standard_normal((B, T, Hkv, D)) * 0.3).astype(np.float32)
    v_new = (rng.standard_normal((B, T, Hkv, D)) * 0.3).astype(np.float32)
    extra = {}
    if use_sinks:
        extra["sinks"] = sinks
    if alibi:
        extra["alibi_slopes"] = np.asarray(jatt.alibi_slopes_for(Hq))
    if self_extend:
        extra["kv_pos"] = (np.arange(S)[None, :] // 2 + np.zeros((B, 1), int)).astype(np.int32)
        extra["q_pos"] = (n_past[:, None] // 2 + np.arange(T)[None, :]).astype(np.int32)
    if n_sh:
        extra["shared_k"] = (rng.standard_normal((1, n_sh, Hkv, D)) * 0.3).astype(np.float32)
        extra["shared_v"] = (rng.standard_normal((1, n_sh, Hkv, D)) * 0.3).astype(np.float32)
    scale = D ** -0.5
    ref, kref, vref = jatt.mha_with_cache(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(n_past), scale, sliding_window=window,
        logit_softcap=softcap, **{n: jnp.asarray(a) for n, a in extra.items()})
    kc, vc = t(k), t(v)
    got, kc2, vc2 = tatt.mha_with_cache(
        t(q), t(k_new), t(v_new), kc, vc, t(n_past), scale, sliding_window=window,
        logit_softcap=softcap, **{n: t(a) for n, a in extra.items()})
    assert kc2 is kc and vc2 is vc  # updated in place
    np.testing.assert_array_equal(kc.numpy(), np.asarray(kref))
    np.testing.assert_array_equal(vc.numpy(), np.asarray(vref))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-3, atol=2e-3)


def test_shared_prefix_with_self_extend_raises():
    q, k, v, n_past, _ = make_case(5)
    with pytest.raises(NotImplementedError, match="shared-prefix KV"):
        tatt.mha_with_cache(t(q), t(k[:, :1]), t(v[:, :1]), t(k), t(v), t(n_past),
                            0.125, kv_pos=torch.zeros((2, 256), dtype=torch.int32),
                            q_pos=torch.zeros((2, 1), dtype=torch.int32),
                            shared_k=t(k[:1, :4]), shared_v=t(v[:1, :4]))

