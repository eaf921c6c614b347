"""Self-extend (grouped attention) in the port (llama_cpp_gfx906_tpu_torch)
against the JAX package, on the CPU.

K3's self-extend mode: the plain version of ``flash_decode`` against the
JAX kernel in interpret mode on the logical-position cases of
tests/test_flash_decode.py:157-275 (with and without ALiBi, a window, an
int8 cache).  The engine on the ``tiny`` llama preset at f32 with every
weight dequantized on both sides: ``seq_div`` / ``seq_add`` (the recipe of
tests/test_state.py:156) give the positions, the next position, the K rows
and the next logits of JAX's, the CLI's self-extend loop (``-gan 2 -gaw
8``) JAX's greedy tokens; the decode route and the captured fused step
follow the cache's positions; ``reset`` drops them.

The JAX forward writes the new rows' logical positions after the step
(JAX models/llama.py:465-476), so under self-extend its new tokens do not
attend to their own rows (a row past the fill level holds the sentinel
while the step runs); the port writes them first, as llama.cpp places a
token's cell before computing it.  The oracle here is the JAX engine with
its forward fed a cache whose plane already holds the new rows' positions
(``own_rows``), for the logits and tokens only: the positions and K rows
are held to the unpatched JAX engine, and one test shows that the patch
changes the unpatched JAX logits and nothing else.

Tolerances: K3 2e-2 of max |jax| (3e-2 over an int8 cache), as the JAX
kernel tests; positions exact; K rows 1e-4 of max |jax| (f32, the same
dense weights); logits 1e-3 of max |jax| with the same argmax; K rows
against keys roped fresh at their new positions 2e-4 (tests/test_state.py);
greedy tokens exact.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_cpp_gfx906_tpu.models.llama import KVCache as JKV
from llama_cpp_gfx906_tpu.ops import decode_stream as jk6
from llama_cpp_gfx906_tpu.ops.attention import alibi_slopes_for as j_slopes
from llama_cpp_gfx906_tpu.ops.decode_step import _fused_ok as j_fused_ok
from llama_cpp_gfx906_tpu.runtime.engine import Engine as JEngine
from llama_cpp_gfx906_tpu.sampling.samplers import SamplerChain as JChain
from llama_cpp_gfx906_tpu.sampling.samplers import SamplerParams as JParams
from llama_cpp_gfx906_tpu.tools.cli import _generate_self_extend as j_self_extend
from llama_cpp_gfx906_tpu_torch.models import llama as tllama
from llama_cpp_gfx906_tpu_torch.models.llama import POS_SENTINEL, KVCache, decode_route
from llama_cpp_gfx906_tpu_torch.ops import decode_step as k7
from llama_cpp_gfx906_tpu_torch.ops import decode_stream as k6
from llama_cpp_gfx906_tpu_torch.ops.attention import mha_with_cache
from llama_cpp_gfx906_tpu_torch.ops.norms import rms_norm
from llama_cpp_gfx906_tpu_torch.ops.rope import apply_rope, inv_freq_for
from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine, _FusedLoop
from llama_cpp_gfx906_tpu_torch.tools.cli import _generate_self_extend
from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

from test_torch_alibi import k3_inputs, run_k3

TOKENS = [3, 17, 42, 9, 7, 25, 33, 11]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return write_synth(str(tmp_path_factory.mktemp("se") / "tiny.gguf"), "tiny", seed=0)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def own_rows(je: JEngine) -> JEngine:
    """``je`` with its forward fed a cache whose position plane already
    holds the new rows' logical positions (see the module docstring)."""
    fwd = je._forward

    def forward(params, cfg, toks, kv, n_tokens=None, *a, **kw):
        if kv.pos is not None:
            T = toks.shape[1]
            adv = jnp.full((toks.shape[0],), T) if n_tokens is None else n_tokens
            t = jnp.arange(T)[None, :]
            vals = jnp.where(t < adv[:, None], kv.pos_next[:, None] + t, 1 << 30)
            pos = jax.vmap(lambda row, start, v: jax.lax.dynamic_update_slice(
                row, v.astype(row.dtype), (start,)))(kv.pos, kv.n_past, vals)
            kv = dataclasses.replace(kv, pos=pos)
        return fwd(params, cfg, toks, kv, n_tokens, *a, **kw)

    je._forward = forward
    return je


def engines(path, patched=True, max_seq=64):
    """A JAX and a port engine on ``path`` at f32, every weight dequantized
    (unfused: ``wk`` apart)."""
    je = JEngine.from_gguf(path, max_seq=max_seq, dtype=jnp.float32, keep_quantized=False)
    te = Engine.from_gguf(path, max_seq=max_seq, dtype=torch.float32, device="cpu",
                          keep_quantized=False)
    return (own_rows(je) if patched else je), te


# ---------------------------------------------------------------------------
# K3's plain version against the JAX kernel (interpret mode)
# ---------------------------------------------------------------------------


def ladder(n_past, S, T, group=2):
    """tests/test_flash_decode.py ``_self_extend_pos``: row i at i // group,
    the T new tokens continuing the ladder."""
    kv_pos = np.broadcast_to(np.arange(S)[None, :] // group, (len(n_past), S))
    q_pos = (n_past[:, None] + np.arange(T)[None, :]) // group
    return kv_pos.astype(np.int32), q_pos.astype(np.int32)


@pytest.mark.parametrize("name,shape,group,extra,tol", [
    ("self_extend", dict(), 2, {}, 2e-2),
    ("self_extend_t4_window", dict(T=4, S=384), 3, dict(sliding_window=32), 2e-2),
    ("self_extend_quant_kv", dict(quant=True), 2, {}, 3e-2),
    ("self_extend_alibi", dict(), 2, "alibi", 2e-2),
])
def test_k3_plain_matches_jax_kernel(name, shape, group, extra, tol):
    """Logical positions: the mask (k <= q on logical positions, live rows
    by the physical fill level, the window on logical positions) and, with
    ALiBi, the distance of logical positions."""
    shape = dict(shape)
    quant = shape.pop("quant", False)
    q, kv, n_past, _ = k3_inputs(11, **shape)
    kv_pos, q_pos = ladder(n_past, kv.shape[2], q.shape[1], group)
    if extra == "alibi":
        extra = dict(alibi_slopes=np.asarray(j_slopes(4)))
    got, want = run_k3(q, kv, n_past, quant=quant, kv_pos=kv_pos, q_pos=q_pos, **extra)
    assert _rel(got, want) < tol


def test_k3_positions_with_shared_rows_raise_as_jax():
    q, kv, n_past, sh = k3_inputs(11, S0=16)
    kv_pos, q_pos = ladder(n_past, kv.shape[2], 1)
    with pytest.raises(NotImplementedError):
        run_k3(q, kv, n_past, sh, kv_pos=kv_pos, q_pos=q_pos)
    with pytest.raises(NotImplementedError, match="self-extend"):
        t = torch.from_numpy
        mha_with_cache(t(q), t(kv[0][:, :1]), t(kv[1][:, :1]), t(kv[0].copy()),
                       t(kv[1].copy()), t(n_past), 0.125, shared_k=t(sh[0]),
                       shared_v=t(sh[1]), kv_pos=t(kv_pos), q_pos=t(q_pos))


# ---------------------------------------------------------------------------
# seq_div / seq_add
# ---------------------------------------------------------------------------


def _raw_keys(te, tokens):
    """Layer 0's keys of ``tokens`` before rope (B 1, T, Hkv, Dh)."""
    p, cfg = te.params["layers"][0], te.cfg
    h = rms_norm(te.params["tok_emb"][torch.tensor([tokens])], p["attn_norm"], cfg.rms_eps)
    return (h @ p["wk"]).reshape(1, len(tokens), cfg.n_kv_heads, cfg.head_dim)


@pytest.mark.parametrize("op,args,want_pos,want_next", [
    ("seq_div", (0, 8, 2), [0, 0, 1, 1, 2, 2, 3, 3], 4),
    ("seq_add", (2, 8, 5), [0, 1, 7, 8, 9, 10, 11, 12], 13),
])
def test_seq_ops_match_jax(model, op, args, want_pos, want_next):
    """After a prefill of 8 tokens, ``op`` against the unpatched JAX
    engine: the positions and the next position, every layer's K rows
    re-roped, layer 0's equal to raw keys roped fresh at the new positions;
    then a decode step: the position plane and next position it leaves as
    the unpatched JAX step's, its row at the next position, and its logits
    as those of JAX fed its own row's position (``own_rows``, the one
    departure)."""
    (je, te), (jp, _) = engines(model, patched=False), engines(model)
    for eng in (je, jp, te):
        eng.prefill(TOKENS)
        getattr(eng, op)(*args)
    for eng in (je, te):
        pos = np.asarray(eng.kv.pos)
        np.testing.assert_array_equal(pos[0, :8], want_pos)
        assert (pos[0, 8:] == POS_SENTINEL).all() and int(eng.kv.pos_next[0]) == want_next
    assert _rel(te.kv.k[:, :, :8].numpy(), np.asarray(je.kv.k)[:, :, :8]) < 1e-4
    inv = inv_freq_for(te.cfg, "cpu")
    fresh = apply_rope(_raw_keys(te, TOKENS), torch.tensor([want_pos]), inv,
                       te.cfg.rope_interleaved)
    np.testing.assert_allclose(te.kv.k[0, 0, :8].numpy(), fresh[0].numpy(),
                               rtol=2e-4, atol=2e-4)
    je.decode_one(50)
    a, b = jp.decode_one(50), te.decode_one(50)
    assert _rel(b, a) < 1e-3 and int(np.argmax(b)) == int(np.argmax(a))
    assert int(te.kv.pos[0, 8]) == want_next and int(te.kv.pos_next[0]) == want_next + 1
    np.testing.assert_array_equal(np.asarray(je.kv.pos), te.kv.pos.numpy())
    np.testing.assert_array_equal(np.asarray(je.kv.pos_next), te.kv.pos_next.numpy())


def test_jax_step_hides_its_own_row(model):
    """The reference-side fault the oracle patches: the unpatched JAX step
    after ``seq_div`` gives other logits than the same step fed its own
    row's position, which the port matches (test_seq_ops_match_jax); the
    two JAX steps leave the same positions, the same K/V rows before the
    step and the same new layer-0 row (the later layers' new rows follow
    the attention each layer gave), so the patch moves only the attention
    of the step's own row."""
    (je, _), (jp, _) = engines(model, patched=False), engines(model)
    outs = []
    for eng in (je, jp):
        eng.prefill(TOKENS)
        eng.seq_div(0, 8, 2)
        outs.append(eng.decode_one(50))
    assert _rel(outs[0], outs[1]) > 1e-3
    for name in ("pos", "pos_next", "n_past"):
        np.testing.assert_array_equal(np.asarray(getattr(je.kv, name)),
                                      np.asarray(getattr(jp.kv, name)))
    for name in ("k", "v"):  # (L, B, S, Hkv, Dh); later layers' new rows follow the logits
        a, b = np.asarray(getattr(je.kv, name)), np.asarray(getattr(jp.kv, name))
        np.testing.assert_array_equal(a[:, :, :8], b[:, :, :8])
        np.testing.assert_array_equal(a[0, :, 8], b[0, :, 8])


def test_seq_ops_refuse_a_model_without_rope(tmp_path):
    """As JAX's: the re-rope needs rope (mpt, bloom have none)."""
    path = write_synth(str(tmp_path / "mpt.gguf"), "tiny-mpt", seed=0)
    te = Engine.from_gguf(path, max_seq=64, dtype=torch.float32, device="cpu")
    te.prefill([3, 4, 5])
    with pytest.raises(ValueError, match="rope"):
        te.seq_div(0, 3, 2)


def test_q8_cache_seq_div(model):
    """A q8 cache: K rows round-trip through f32 for the re-rope and are
    quantized again; positions as a bf16 cache's; a decode step runs."""
    te = Engine.from_gguf(model, max_seq=64, dtype=torch.float32, device="cpu",
                          keep_quantized=False, kv_cache_dtype="q8")
    te.prefill(TOKENS)
    before = te.kv.k.q[:, :, :8].clone()
    te.seq_div(0, 8, 2)
    np.testing.assert_array_equal(te.kv.pos[0, :8].numpy(), [0, 0, 1, 1, 2, 2, 3, 3])
    assert not torch.equal(before, te.kv.k.q[:, :, :8])
    assert np.isfinite(te.decode_one(50)).all() and int(te.kv.pos_next[0]) == 5


# ---------------------------------------------------------------------------
# the CLI's self-extend loop
# ---------------------------------------------------------------------------


def test_cli_self_extend_matches_jax(model):
    """``-gan 2 -gaw 8``: the ladder runs at 8, 12, 16, ... logical
    positions; 16 greedy tokens after a ~20-token prompt, as JAX's CLI
    loop gives them, and the cache's positions as JAX's."""
    je, te = engines(model, max_seq=256)  # the JAX prefill pads to 128 rows
    prompt = "tok5 tok77 the quick brown fox jumps over tok300"
    args = types.SimpleNamespace(grp_attn_n=2, grp_attn_w=8, n_predict=16)
    want = []
    j_self_extend(je, prompt, args, JChain(JParams(greedy=True), je.cfg.n_vocab),
                  want.append, {"stopped": False})
    ids = te.tokenizer.tokenize(prompt, add_special=True, parse_special=True)
    assert len(ids) > 8
    got = _generate_self_extend(te, ids, 16, 2, 8)
    assert got == want and len(got) == 16
    n = te.n_past
    np.testing.assert_array_equal(np.asarray(je.kv.pos)[0, :n], te.kv.pos[0, :n].numpy())
    assert int(te.kv.pos_next[0]) < n  # compressed


# ---------------------------------------------------------------------------
# the route, the captured step and reset follow the positions
# ---------------------------------------------------------------------------


def test_gates_refuse_positions_as_jax(tmp_path):
    """K6's and K7's gates take the ``small`` stack's bf16 cache, and refuse
    it once it carries logical positions, as JAX's do."""
    path = write_synth(str(tmp_path / "small.gguf"), "small", seed=0)
    je = JEngine.from_gguf(path, max_seq=256, dtype=jnp.bfloat16)
    te = Engine.from_gguf(path, max_seq=256, dtype=torch.bfloat16, device="cpu")
    jkv = JKV.create(je.cfg, batch=1, max_seq=256, dtype=jnp.bfloat16)
    kv = KVCache.create(te.cfg, 1, 256, torch.bfloat16)
    assert jk6._stream_ok(je.params, je.cfg, jkv, 1, 1)
    assert k6._stream_ok(te.params, te.cfg, kv, 1, 1)
    jkv = dataclasses.replace(jkv, pos=jnp.zeros((1, 256), jnp.int32),
                              pos_next=jnp.zeros((1,), jnp.int32))
    kv.pos, kv.pos_next = torch.zeros((1, 256), dtype=torch.int32), kv.n_past.clone()
    want = (jk6._stream_ok(je.params, je.cfg, jkv, 1, 1),
            j_fused_ok(je.params, je.cfg, jkv, 1, 1))
    got = (k6._stream_ok(te.params, te.cfg, kv, 1, 1),
           k7._fused_ok(te.params, te.cfg, kv, 1, 1))
    assert got == want == (False, False)


def test_route_and_graph_follow_positions(tmp_path, monkeypatch):
    """A route chosen (K7, on the Q8_0 stack) and a step captured before
    ``seq_div`` are not
    reused once the cache carries positions: the route is the loop, the
    captured step is stale; after ``reset`` the positions are gone and the
    step captured with them is stale again.  (The route is decided as on
    the card: the device test is patched.)"""
    path = write_synth(str(tmp_path / "tiny-q8_0.gguf"), "tiny-q8_0", seed=0)
    te = Engine.from_gguf(path, max_seq=256, dtype=torch.bfloat16, device="cpu")
    monkeypatch.setattr(tllama, "_on_card", lambda kv: True)
    te.params.__dict__.pop("_decode_routes")  # decided at load, off the card
    assert decode_route(te.params, te.cfg, te.kv) == "k7"
    st = _FusedLoop(8, te.device)
    st.graph, st.key = object(), te._graph_key()
    assert not te._graph_stale(st)
    te.prefill(TOKENS)
    te.seq_div(0, 8, 2)
    assert decode_route(te.params, te.cfg, te.kv) is None
    assert te._graph_stale(st)
    st.key = te._graph_key()
    te.seq_add(0, 4, 1)  # the planes are updated in place: the step holds
    assert not te._graph_stale(st)
    te.reset()
    assert te.kv.pos is None and te.kv.pos_next is None
    assert te._graph_stale(st) and decode_route(te.params, te.cfg, te.kv) == "k7"


def test_set_n_past_trims_positions(model):
    """Rewinding keeps the positions of the rows that stay, gives the
    others the sentinel and moves the next position back; at 0 they go."""
    _, te = engines(model)
    te.prefill(TOKENS)
    te.seq_div(0, 8, 2)
    te.decode_one(50)
    te.set_n_past(6)
    np.testing.assert_array_equal(te.kv.pos[0, :6].numpy(), [0, 0, 1, 1, 2, 2])
    assert (te.kv.pos[0, 6:] == POS_SENTINEL).all() and int(te.kv.pos_next[0]) == 3
    te.set_n_past(0)
    assert te.kv.pos is None


def test_fused_loop_with_positions_matches_decode_one(model):
    """The fused loop (its CPU form) after ``seq_div`` gives the greedy
    tokens of ``decode_one`` from the same state, and the same positions."""
    outs = []
    for fused in (False, True):
        _, te = engines(model)
        tok = int(np.argmax(te.prefill(TOKENS)))
        te.seq_div(0, 8, 2)
        if fused:
            toks = te.decode_fused(tok, n_steps=6)
        else:
            toks = []
            for _ in range(6):
                tok = int(np.argmax(te.decode_one(tok)))
                toks.append(tok)
        outs.append((toks, te.kv.pos[0, :14].tolist(), int(te.kv.pos_next[0])))
    assert outs[0] == outs[1]
