"""Port parity: rms_norm and rope (llama_cpp_gfx906_tpu_torch.ops) against the
JAX package.  f32 results agree to 1e-5; bf16 inputs to one bf16 ulp."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama_cpp_gfx906_tpu.gguf.constants import RopeScalingType as JRope
from llama_cpp_gfx906_tpu.models.config import ModelConfig as JConfig
from llama_cpp_gfx906_tpu.ops.norms import rms_norm as j_rms_norm
from llama_cpp_gfx906_tpu.ops.rope import apply_rope as j_apply_rope
from llama_cpp_gfx906_tpu.ops.rope import rope_frequencies as j_rope_frequencies
from llama_cpp_gfx906_tpu_torch.gguf.constants import RopeScalingType
from llama_cpp_gfx906_tpu_torch.models.config import ModelConfig
from llama_cpp_gfx906_tpu_torch.ops.norms import rms_norm
from llama_cpp_gfx906_tpu_torch.ops.rope import apply_rope, rope_frequencies


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small CPU ops, fastest on one thread; under
    pytest-xdist, torch's default of one thread per core in every worker
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 96)).astype(np.float32) * 3
    w = rng.standard_normal(96).astype(np.float32)
    ref = np.asarray(j_rms_norm(jnp.asarray(x, dtype), jnp.asarray(w), 1e-5), np.float32)
    got = rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                   torch.from_numpy(w), 1e-5).float().numpy()
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


SCALINGS = [
    dict(),
    dict(rope_scaling="LINEAR", rope_scale=4.0),
    dict(rope_scaling="YARN", rope_scale=8.0, rope_orig_ctx=8192,
         rope_low_freq_factor=1.0, rope_high_freq_factor=4.0),
    dict(rope_dim=32),
]


def _configs(**kw):
    common = dict(arch="llama", n_layers=1, n_embd=256, n_heads=4, n_kv_heads=2,
                  head_dim=64, n_ff=512, n_vocab=100, n_ctx_train=4096,
                  rope_base=500000.0)
    jkw, tkw = dict(common), dict(common)
    for k, v in kw.items():
        if k == "rope_scaling":
            jkw[k], tkw[k] = JRope[v], RopeScalingType[v]
        else:
            jkw[k] = tkw[k] = v
    return JConfig(**jkw), ModelConfig(**tkw)


@pytest.mark.parametrize("scaling", SCALINGS)
def test_rope_frequencies(scaling):
    jcfg, tcfg = _configs(**scaling)
    np.testing.assert_array_equal(rope_frequencies(tcfg), j_rope_frequencies(jcfg))


@pytest.mark.parametrize("rope_dim", [64, 32])
@pytest.mark.parametrize("interleaved", [True, False])
def test_apply_rope(interleaved, rope_dim):
    jcfg, tcfg = _configs(rope_dim=rope_dim)
    inv = rope_frequencies(tcfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 64)).astype(np.float32)
    pos = (np.arange(7)[None, :] + np.asarray([[0], [1000]])).astype(np.int32)
    ref = np.asarray(j_apply_rope(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(inv),
                                  interleaved))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                     torch.from_numpy(inv), interleaved).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    if rope_dim < 64:
        np.testing.assert_array_equal(got[..., rope_dim:], x[..., rope_dim:])
