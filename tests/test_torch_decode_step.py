"""K7 (ops/decode_step.py): the port's gate and plain version against the
JAX package's fused decode megakernel, run as the JAX tests run it on the
CPU (``interpret=True``), at tests/test_decode_step.py's sizes and
tolerance (L 3, D 128, Dh 128, S 256; logits and KV within 2e-2)."""

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
from llama_cpp_gfx906_tpu.ops import quant_matmul as jqmm
from llama_cpp_gfx906_tpu.ops.decode_step import _fused_ok as j_fused_ok
from llama_cpp_gfx906_tpu.ops.decode_step import fused_decode_step as j_k7
from llama_cpp_gfx906_tpu.ops.norms import rms_norm as j_rms_norm
from llama_cpp_gfx906_tpu.runtime.weights import fuse_projections as j_fuse
from llama_cpp_gfx906_tpu_torch.models.config import ModelConfig
from llama_cpp_gfx906_tpu_torch.models.llama import (
    FUSED_LAYER_BYTES,
    KVCache,
    layer_bytes,
)
from llama_cpp_gfx906_tpu_torch.ops import decode_step as k7
from llama_cpp_gfx906_tpu_torch.ops.norms import rms_norm
from llama_cpp_gfx906_tpu_torch.ops.quant_matmul import QuantTensor, linear
from llama_cpp_gfx906_tpu_torch.runtime.weights import params_from_jax

L, D, HQ, HKV, DH, F, V, S = 3, 128, 2, 1, 128, 256, 64, 256
TOL = 2e-2


def j_cfg(**kw):
    return JConfig(arch="llama", n_layers=L, n_embd=D, n_heads=HQ, n_kv_heads=HKV,
                   head_dim=DH, n_ff=F, n_vocab=V, n_ctx_train=S, **kw)


def port_cfg(jcfg) -> ModelConfig:
    names = [f.name for f in dataclasses.fields(ModelConfig) if f.name != "rope_scaling"]
    return ModelConfig(**{n: getattr(jcfg, n) for n in names})


def make_params(rng):
    """tests/test_decode_step.py's Q8_0 stack."""
    def qstack(K, N):
        w = rng.standard_normal((N, K), dtype=np.float32) * 0.05
        qt = jqmm.pack_gguf_tensor(quantize(w, GGMLType.Q8_0), GGMLType.Q8_0, (N, K))
        return jqmm.QuantTensor(q=jnp.stack([qt.q] * L), s=jnp.stack([qt.s] * L),
                                m=None, fmt=qt.fmt, group=qt.group, shape=qt.shape)

    head = rng.standard_normal((V, D), dtype=np.float32) * 0.05
    return {
        "tok_emb": jnp.asarray(rng.standard_normal((V, D)) * 0.1, jnp.bfloat16),
        "out_norm": jnp.ones(D, jnp.float32),
        "lm_head": jqmm.pack_gguf_tensor(quantize(head, GGMLType.Q8_0),
                                         GGMLType.Q8_0, (V, D)),
        "layers": j_fuse({
            "attn_norm": jnp.ones((L, D), jnp.float32) * 1.1,
            "ffn_norm": jnp.ones((L, D), jnp.float32) * 0.9,
            "wq": qstack(D, HQ * DH), "wk": qstack(D, HKV * DH),
            "wv": qstack(D, HKV * DH), "wo": qstack(HQ * DH, D),
            "w_gate": qstack(D, F), "w_up": qstack(D, F), "w_down": qstack(F, D)}),
    }


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


@functools.lru_cache(maxsize=None)
def _j_step(jcfg):
    return jax.jit(lambda p, x, kv: j_k7(p, jcfg, x, kv, interpret=True))


@pytest.mark.parametrize("interleaved,n_prompt", [(True, 7), (False, 7), (True, 135)])
def test_k7_plain_matches_jax(interleaved, n_prompt):
    jcfg = j_cfg(rope_interleaved=interleaved)
    cfg = port_cfg(jcfg)
    rng = np.random.default_rng(3)
    jp = make_params(rng)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg)
    jkv = JKV.create(jcfg, batch=1, max_seq=S, dtype=jnp.bfloat16)
    assert j_fused_ok(jp, jcfg, jkv, 1, 1)
    _, jkv = j_forward(jp, jcfg, jnp.asarray([list(rng.integers(0, V, n_prompt))],
                                             jnp.int32), jkv)
    kv = KVCache(k=_t(jkv.k), v=_t(jkv.v), n_past=torch.tensor([n_prompt], dtype=torch.int32))
    assert k7._fused_ok(params, cfg, kv, 1, 1)
    tok = np.asarray([[5]], np.int32)
    for _ in range(2):
        jx2, jk, jv = _j_step(jcfg)(jp, jp["tok_emb"][tok], jkv)
        jkv = JKV(k=jk, v=jv, n_past=jkv.n_past + 1)
        x2 = k7.fused_decode_step(params, cfg, params["tok_emb"][torch.from_numpy(tok)], kv)
        kv.n_past += 1
        jl = _f32(jqmm.linear(j_rms_norm(jx2, jp["out_norm"], jcfg.rms_eps), jp["lm_head"]))
        tl = _f32(linear(rms_norm(x2, params["out_norm"], cfg.rms_eps), params["lm_head"]))
        np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
        assert int(np.argmax(tl)) == int(np.argmax(jl))
        np.testing.assert_allclose(_f32(kv.k), _f32(jkv.k), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(_f32(kv.v), _f32(jkv.v), rtol=TOL, atol=TOL)
        tok = np.asarray([[int(np.argmax(jl))]], np.int32)


def test_fused_gate_parity():
    """tests/test_decode_step.py:107's cases that the port can express, and
    the weight layouts K7 refuses (they go to K6 or the loop)."""
    jp = make_params(np.random.default_rng(4))
    jcfg = j_cfg()
    cfg = port_cfg(jcfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg)

    def both(B, T, kv_batch=1, kv_len=S, jparams=jp, tparams=params):
        jkv = JKV.create(jcfg, batch=kv_batch, max_seq=kv_len, dtype=jnp.bfloat16)
        kv = KVCache.create(cfg, kv_batch, kv_len, torch.bfloat16)
        return (j_fused_ok(jparams, jcfg, jkv, B, T),
                k7._fused_ok(tparams, cfg, kv, B, T))

    assert both(1, 1) == (True, True)
    assert both(1, 2) == (False, False)  # prefill
    assert both(2, 1) == (False, False)  # batch
    assert both(2, 1, kv_batch=2) == (False, False)
    assert both(1, 1, kv_len=200) == (False, False)
    # mins (a Q4_0-style affine plane) or folded scales: not K7's
    rng = np.random.default_rng(6)
    for qtype, fold in ((GGMLType.Q4_K, True), (GGMLType.Q6_K, True)):
        w = rng.standard_normal((D, F), dtype=np.float32) * 0.05
        qt = jqmm.pack_gguf_tensor(quantize(w, qtype), qtype, (D, F), fold_scales=fold)
        st = lambda a: jnp.stack([a] * L) if a is not None else None  # noqa: E731
        down = jqmm.QuantTensor(q=st(qt.q), s=st(qt.s), m=st(qt.m), fmt=qt.fmt,
                                group=qt.group, shape=qt.shape, sd=st(qt.sd),
                                md=st(qt.md), sgroup=qt.sgroup)
        jl = dict(jp["layers"], w_down=down)
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, dict(jp, layers=jl)), cfg)
        assert both(1, 1, jparams=dict(jp, layers=jl), tparams=tp) == (False, False)


def test_270m_q8_0_preset_planes_match_jax_packer(tmp_path):
    """The ``270m-q8_0`` synthetic preset, cut to one layer and 512 tokens
    (its first layer's rows are the full preset's): every plane the port
    loads is byte-equal to what the JAX loader packs from the same file,
    the layer is the K7 size (5,570,560 int8 bytes + 696,320 scale bytes
    <= 6 MiB) and K7's gate admits it."""
    from llama_cpp_gfx906_tpu.runtime.engine import Engine as JEngine
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import PRESETS, write_synth

    path = write_synth(str(tmp_path / "270m.gguf"), "270m-q8_0", seed=0,
                       n_layers=1, n_vocab=512)
    te = Engine.from_gguf(path, max_seq=256, dtype=torch.float32, device="cpu")
    je = JEngine.from_gguf(path, max_seq=256, dtype=jnp.float32)
    assert (te.cfg.n_embd, te.cfg.n_heads, te.cfg.n_kv_heads, te.cfg.head_dim,
            te.cfg.n_ff) == PRESETS["270m-q8_0"][1:6]
    jl, tl = je.params["layers"], te.params["layers"][0]
    assert sorted(tl.keys()) == sorted(jl.keys())
    for key, jv in jl.items():
        if not hasattr(jv, "fmt"):
            assert np.asarray(jv)[0].tobytes() == tl[key].numpy().tobytes(), key
            continue
        assert tl[key].fmt == jv.fmt == "int8" and tl[key].group == jv.group
        for name in ("q", "s", "m", "sd", "md"):
            a, b = getattr(jv, name), getattr(tl[key], name)
            assert (a is None) == (b is None), (key, name)
            if a is not None:
                assert np.asarray(a)[0].tobytes() == b.numpy().tobytes(), (key, name)
    assert layer_bytes(te.params) == 5_570_560 + 696_320 <= FUSED_LAYER_BYTES
    assert k7._fused_ok(te.params, te.cfg, te.kv, 1, 1)


def test_k7_layer_bytes_split():
    """The JAX forward's 6 MiB split: this stack's layers are small; a
    layer's q and s planes are what count."""
    jp = make_params(np.random.default_rng(4))
    cfg = port_cfg(j_cfg())
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg)
    p = params["layers"][0]
    want = sum(p[k].q.nbytes + p[k].s.nbytes
               for k in ("wqkv_fused", "wo", "wgateup_fused", "w_down"))
    assert layer_bytes(params) == want <= FUSED_LAYER_BYTES
    assert isinstance(p["wqkv_fused"], QuantTensor)


def test_k7_loop_gap_matches_jax_reference(tmp_path):
    """The 270M Q8_0 preset at its full width and 18 layers: 8 decode
    steps from one state through K7 and through the per-layer loop, in both
    packages (JAX: K7 in interpret mode against its layer scan; the port:
    K7's plain version against ``layers_forward``).  The fused route does
    not round where the loop does (f32 carry, each int8 weight rounded to
    bf16 before its product), and with these random weights the difference
    grows with depth: the JAX package's own K7 sits ~3.6e-2 (max |diff| /
    max |loop|) from its loop here, beyond the 2e-2 its shallow tests use.
    The port's gap must be no larger than 1.5x the reference's."""
    from llama_cpp_gfx906_tpu.runtime.engine import Engine as JEngine
    from llama_cpp_gfx906_tpu_torch.models.llama import layers_forward
    from llama_cpp_gfx906_tpu_torch.ops.decode_stream import decode_layers_plain
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

    path = write_synth(str(tmp_path / "270m.gguf"), "270m-q8_0", seed=0, n_vocab=512)
    je = JEngine.from_gguf(path, max_seq=256, dtype=jnp.bfloat16)
    te = Engine.from_gguf(path, max_seq=256, device="cpu")
    words = " ".join(f"w{i % 97}" for i in range(40))
    ids = te.tokenizer.tokenize(f"The synthetic model reads: {words}",
                                add_special=True, parse_special=True)[:64]
    jp, jcfg = je.params, je.cfg
    tok = int(np.argmax(je.prefill(ids)))
    kv0 = je.kv
    assert j_fused_ok(jp, jcfg, kv0, 1, 1)

    def j_head(x):
        return _f32(jqmm.linear(j_rms_norm(x, jp["out_norm"], jcfg.rms_eps),
                                jp["lm_head"]))[0, -1]

    fed, j_fused, kv = [], [], kv0
    for _ in range(8):
        fed.append(tok)
        x2, k, v = _j_step(jcfg)(jp, jp["tok_emb"][jnp.asarray([[tok]])], kv)
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
                x = layers_fn(p, te.cfg, p["tok_emb"][torch.tensor([[t]])], te.kv)
                out.append(_f32(linear(rms_norm(x, p["out_norm"], te.cfg.rms_eps),
                                       p["lm_head"]))[0, -1])
                te.set_n_past(te.n_past + 1)
        return out

    def gap(xs, ys):
        return max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(xs, ys))

    jax_gap = gap(j_fused, j_loop)
    port_gap = gap(t_run(decode_layers_plain), t_run(layers_forward))
    print(f"K7 vs the per-layer loop, L=18: JAX {jax_gap:.5f}, port {port_gap:.5f}")
    assert port_gap <= 1.5 * jax_gap
