"""K6 (ops/decode_stream.py): the port's gate and plain version against the
JAX package's streamed decode megakernel, run as the JAX tests run it on
the CPU (``interpret=True``), at the JAX tests' sizes and tolerances
(tests/test_decode_stream.py: L 3, D 256, Dh 128, S 256; logits 2e-2 and
KV 3e-2 for Q8_0; 8e-2 and 6e-2 for the Q4_K_M mix, whose coarser rounding
walks differ more between the two paths).

Inputs come from numpy seeds; the JAX parameter tree crosses over with
``runtime/weights.py:params_from_jax``, so both packages read the same
bytes.  Each step feeds both paths the JAX path's greedy token.
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
from llama_cpp_gfx906_tpu.ops import quant_matmul as jqmm
from llama_cpp_gfx906_tpu.ops.decode_stream import _stream_ok as j_stream_ok
from llama_cpp_gfx906_tpu.ops.decode_stream import fused_decode_step_streamed as j_k6
from llama_cpp_gfx906_tpu.ops.norms import rms_norm as j_rms_norm
from llama_cpp_gfx906_tpu.runtime.weights import fuse_projections as j_fuse
from llama_cpp_gfx906_tpu_torch.models.config import ModelConfig
from llama_cpp_gfx906_tpu_torch.models.llama import KVCache, decode_route, layers_forward
from llama_cpp_gfx906_tpu_torch.ops import decode_stream as k6
from llama_cpp_gfx906_tpu_torch.ops.norms import rms_norm
from llama_cpp_gfx906_tpu_torch.ops.quant_matmul import QuantTensor, linear
from llama_cpp_gfx906_tpu_torch.runtime.weights import layer_table, params_from_jax

L, D, HQ, HKV, DH, F, V, S = 3, 256, 2, 1, 128, 512, 64, 256


def port_cfg(jcfg) -> ModelConfig:
    names = [f.name for f in dataclasses.fields(ModelConfig) if f.name != "rope_scaling"]
    return ModelConfig(**{n: getattr(jcfg, n) for n in names})


def j_cfg(**kw):
    return JConfig(arch="llama", n_layers=L, n_embd=D, n_heads=HQ, n_kv_heads=HKV,
                   head_dim=DH, n_ff=F, n_vocab=V, n_ctx_train=S, **kw)


def _stack(qt, n=L):
    st = lambda a: jnp.stack([a] * n) if a is not None else None  # noqa: E731
    return jqmm.QuantTensor(q=st(qt.q), s=st(qt.s), m=st(qt.m), fmt=qt.fmt,
                            group=qt.group, shape=qt.shape, sd=st(qt.sd),
                            md=st(qt.md), sgroup=qt.sgroup)


def _packed(rng, K, N, qtype, fold=False):
    w = rng.standard_normal((N, K), dtype=np.float32) * 0.05
    return _stack(jqmm.pack_gguf_tensor(quantize(w, qtype), qtype, (N, K),
                                        fold_scales=fold))


def _head(rng, d):
    head = rng.standard_normal((V, d), dtype=np.float32) * 0.05
    return {"tok_emb": jnp.asarray(rng.standard_normal((V, d)) * 0.1, jnp.bfloat16),
            "out_norm": jnp.ones(d, jnp.float32),
            "lm_head": jqmm.pack_gguf_tensor(quantize(head, GGMLType.Q8_0),
                                             GGMLType.Q8_0, (V, d))}


def q8_params(rng):
    """The JAX test's Q8_0 stack (fused q|k|v)."""
    q8 = functools.partial(_packed, rng, qtype=GGMLType.Q8_0)
    return dict(_head(rng, D), layers=j_fuse({
        "attn_norm": jnp.ones((L, D), jnp.float32) * 1.1,
        "ffn_norm": jnp.ones((L, D), jnp.float32) * 0.9,
        "wq": q8(D, HQ * DH), "wk": q8(D, HKV * DH), "wv": q8(D, HKV * DH),
        "wo": q8(HQ * DH, D), "w_gate": q8(D, F), "w_up": q8(D, F),
        "w_down": q8(F, D)}))


def q4km(fold, seed=11):
    """The JAX test's Q4_K_M disposition: Q4_K nib4c, a Q6_K attn_v split
    out, optionally folded scales; dims twice the module's."""
    d, hq, dh, f = 512, 4, 128, 1024
    rng = np.random.default_rng(seed)
    q4 = functools.partial(_packed, rng, qtype=GGMLType.Q4_K, fold=fold)
    layers = j_fuse({
        "attn_norm": jnp.ones((L, d), jnp.float32) * 1.1,
        "ffn_norm": jnp.ones((L, d), jnp.float32) * 0.9,
        "wq": q4(d, hq * dh), "wk": q4(d, dh),
        "wv": _packed(rng, d, dh, GGMLType.Q6_K, fold),
        "wo": q4(hq * dh, d), "w_gate": q4(d, f), "w_up": q4(d, f),
        "w_down": q4(f, d)})
    assert layers["wqk_fused"].fmt == "nib4c" and layers["wv"].fmt == "int8"
    jcfg = JConfig(arch="llama", n_layers=L, n_embd=d, n_heads=hq, n_kv_heads=1,
                   head_dim=dh, n_ff=f, n_vocab=V, n_ctx_train=S)
    return jcfg, dict(_head(rng, d), layers=layers)


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


@functools.lru_cache(maxsize=None)
def _j_step(jcfg):
    return jax.jit(lambda p, x, kv: j_k6(p, jcfg, x, kv, interpret=True))


def lockstep(jcfg, jparams, lens, steps=2, logit_tol=2e-2, kv_tol=3e-2, seed=7):
    """Prefill each slot (the JAX forward), then decode ``steps`` tokens
    through the JAX kernel and the port's K6 (plain on the CPU) from the
    same cache, comparing logits and the whole cache after every step."""
    cfg = port_cfg(jcfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    rng = np.random.default_rng(seed)
    B = len(lens)
    jkv = JKV.create(jcfg, batch=B, max_seq=S, dtype=jnp.bfloat16)
    toks = np.zeros((B, max(lens)), np.int32)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(0, V, n)
    _, jkv = j_forward(jparams, jcfg, jnp.asarray(toks), jkv,
                       n_tokens=jnp.asarray(lens, jnp.int32))
    kv = KVCache(k=_t(jkv.k), v=_t(jkv.v), n_past=torch.tensor(lens, dtype=torch.int32))
    assert j_stream_ok(jparams, jcfg, jkv, B, 1)
    assert k6._stream_ok(params, cfg, kv, B, 1)
    tok = rng.integers(0, V, (B, 1)).astype(np.int32)
    for _ in range(steps):
        jx2, jk, jv = _j_step(jcfg)(jparams, jparams["tok_emb"][tok], jkv)
        jkv = JKV(k=jk, v=jv, n_past=jkv.n_past + 1)
        x2 = k6.fused_decode_step_streamed(params, cfg,
                                           params["tok_emb"][torch.from_numpy(tok)], kv)
        kv.n_past += 1
        jl = _f32(jqmm.linear(j_rms_norm(jx2, jparams["out_norm"], jcfg.rms_eps),
                              jparams["lm_head"]))
        tl = _f32(linear(rms_norm(x2, params["out_norm"], cfg.rms_eps),
                         params["lm_head"]))
        np.testing.assert_allclose(tl, jl, rtol=logit_tol, atol=logit_tol)
        np.testing.assert_allclose(_f32(kv.k), _f32(jkv.k), rtol=kv_tol, atol=kv_tol)
        np.testing.assert_allclose(_f32(kv.v), _f32(jkv.v), rtol=kv_tol, atol=kv_tol)
        tok = np.argmax(jl[:, 0], -1).reshape(B, 1).astype(np.int32)


@pytest.mark.parametrize("interleaved,n_prompt", [
    (True, 7),     # self term + one KV chunk
    (False, 7),    # NEOX rope
    (True, 135),   # crosses a KV chunk
])
def test_k6_plain_matches_jax_q8_0(interleaved, n_prompt):
    jcfg = j_cfg(rope_interleaved=interleaved)
    lockstep(jcfg, q8_params(np.random.default_rng(3)), [n_prompt])


@pytest.mark.parametrize("fold", [False, True])
def test_k6_plain_matches_jax_q4km_split_v(fold):
    jcfg, jparams = q4km(fold)
    lockstep(jcfg, jparams, [7], logit_tol=8e-2, kv_tol=6e-2)


def test_k6_plain_matches_jax_ragged_slots():
    """B = 4 slots at n_past 7, 135, 1 and 40: one weight stream, per-slot
    rope, KV rows and attention ranges."""
    lockstep(j_cfg(), q8_params(np.random.default_rng(3)), [7, 135, 1, 40])


def _gate_pair(jparams, jcfg, B, T, kv_batch=1, kv_len=S):
    cfg = port_cfg(jcfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    jkv = JKV.create(jcfg, batch=kv_batch, max_seq=kv_len, dtype=jnp.bfloat16)
    kv = KVCache.create(cfg, kv_batch, kv_len, torch.bfloat16)
    return j_stream_ok(jparams, jcfg, jkv, B, T), k6._stream_ok(params, cfg, kv, B, T)


def test_stream_gate_parity():
    """The JAX gate test's cases (tests/test_decode_stream.py:203,335) that
    the port can express give the same verdict in both packages."""
    jp = q8_params(np.random.default_rng(4))
    jcfg = j_cfg()
    assert _gate_pair(jp, jcfg, 1, 1) == (True, True)
    assert _gate_pair(jp, jcfg, 2, 1) == (False, False)  # cache batch 1
    assert _gate_pair(jp, jcfg, 1, 2) == (False, False)  # prefill
    assert _gate_pair(jp, jcfg, 1, 1, kv_len=200) == (False, False)  # S % 128
    # K below the smallest chunk cap
    tiny = dict(jp["layers"])
    t = tiny["wqkv_fused"]
    tiny["wqkv_fused"] = jqmm.QuantTensor(q=t.q[:, :128], s=t.s[:, :4], m=None,
                                          fmt="int8", group=32, shape=(128, t.shape[1]))
    tiny_cfg = JConfig(arch="llama", n_layers=L, n_embd=128, n_heads=HQ,
                       n_kv_heads=HKV, head_dim=DH, n_ff=F, n_vocab=V, n_ctx_train=S)
    assert _gate_pair(dict(jp, layers=tiny), tiny_cfg, 1, 1) == (False, False)
    # one folded projection among plain ones
    rng = np.random.default_rng(19)
    mixed = dict(jp["layers"])
    mixed["w_down"] = _stack(jqmm.pack_gguf_tensor(
        quantize(rng.standard_normal((D, F), dtype=np.float32) * 0.05, GGMLType.Q4_K),
        GGMLType.Q4_K, (D, F), fold_scales=True))
    assert _gate_pair(dict(jp, layers=mixed), jcfg, 1, 1) == (False, False)
    # the split-v Q4_K_M disposition, folded or not, and its ragged batch
    for fold in (False, True):
        qcfg, qp = q4km(fold)
        assert _gate_pair(qp, qcfg, 1, 1) == (True, True)
        assert _gate_pair(qp, qcfg, 3, 1, kv_batch=3) == (True, True)


def test_stream_gate_needs_uniform_layers():
    """Per-layer params: one layer whose projection differs in layout fails
    the port's gate (the JAX package's stacked planes cannot differ)."""
    jp = q8_params(np.random.default_rng(4))
    cfg = port_cfg(j_cfg())
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg)
    kv = KVCache.create(cfg, 1, S, torch.bfloat16)
    assert k6._stream_ok(params, cfg, kv, 1, 1)
    wo = params["layers"][1]["wo"]
    params["layers"][1]["wo"] = QuantTensor(
        wo.q, wo.s.repeat_interleave(2, 0), None, "int8", 16, wo.shape)
    assert not k6._stream_ok(params, cfg, kv, 1, 1)


def test_plain_k6_matches_port_layer_loop():
    """The plain K6 against the port's own per-layer loop on the CPU (the
    route the CPU takes), the same step from the same cache."""
    jp = q8_params(np.random.default_rng(5))
    cfg = port_cfg(j_cfg())
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg)
    caches = []
    for _ in range(2):
        g = torch.Generator().manual_seed(0)
        kv = KVCache.create(cfg, 1, S, torch.bfloat16)
        kv.k.copy_(torch.randn(kv.k.shape, generator=g) * 0.5)
        kv.v.copy_(torch.randn(kv.v.shape, generator=g) * 0.5)
        kv.n_past.fill_(50)
        caches.append(kv)
    assert decode_route(params, cfg, caches[0]) is None  # CPU: the loop
    x = params["tok_emb"][torch.tensor([[9]])]
    a = k6.fused_decode_step_streamed_plain(params, cfg, x, caches[0])
    b = layers_forward(params, cfg, x, caches[1])
    assert float((a.float() - b.float()).abs().max() / b.float().abs().max()) < 2e-2
    assert torch.allclose(caches[0].k.float(), caches[1].k.float(), atol=3e-2, rtol=3e-2)


def test_layer_table_addresses():
    jcfg, jp = q4km(True)
    cfg = port_cfg(jcfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg)
    table = layer_table(params, cfg)
    assert table.shape == (L, k6.TABLE_W) and table.dtype == torch.int64
    assert layer_table(params, cfg) is table  # built once, held with the params
    for li, p in enumerate(params["layers"]):
        row = table[li].tolist()
        assert row[0] == p["wqk_fused"].q.data_ptr()
        assert row[5 + 3] == p["wv"].sd.data_ptr() and row[5 + 2] == 0  # v: no mins
        assert row[20] == p["w_down"].q.data_ptr()
        assert row[25:] == [p["attn_norm"].data_ptr(), p["ffn_norm"].data_ptr(), 0]
