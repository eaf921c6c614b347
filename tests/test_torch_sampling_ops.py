"""The port's on-device sampler (ops/sampling_ops.py) and fused decode loop
(Engine.decode_fused / generate_fused) against the JAX package on the CPU.

Greedy is exact, so greedy picks and the sampler's deterministic corners
(top_k 1, a tiny top_p, min_p near 1, a penalty under top_k 1) must equal
the JAX sampler's picks.  The Gumbel noise comes from different generators
in the two packages, so stochastic picks are checked for their support and
their reproducibility only.  The fused loop's greedy tokens must equal the
port's own ``generate`` and the JAX ``Engine.generate_fused`` on the
committed tinydoc fixture.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_cpp_gfx906_tpu.ops.sampling_ops import sample_tokens as j_sample
from llama_cpp_gfx906_tpu.runtime.engine import Engine as JEngine
from llama_cpp_gfx906_tpu.sampling.samplers import SamplerParams as JParams
from llama_cpp_gfx906_tpu_torch.ops.sampling_ops import CAND, sample_tokens, top_candidates
from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
from llama_cpp_gfx906_tpu_torch.sampling.samplers import SamplerParams

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
TINYDOC = os.path.join(FIX, "tinydoc-byte.f16.gguf")
B, V = 4, 3000


def _inputs(seed, temp, top_k, top_p, min_p, penalty, n_recent=16):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    recent = np.full((B, 64), -1, np.int32)
    # each slot's recent window holds its own top tokens and some others
    top = np.argsort(-logits, -1)[:, :3]
    recent[:, -n_recent:] = rng.integers(0, V, (B, n_recent))
    recent[:, -3:] = top
    vec = lambda v, dt: np.full((B,), v, dt)  # noqa: E731
    return (logits, vec(temp, np.float32), vec(top_k, np.int32), vec(top_p, np.float32),
            vec(min_p, np.float32), vec(penalty, np.float32), recent)


def _both(args, uniforms_seed=0):
    logits, temp, top_k, top_p, min_p, pen, recent = args
    j = np.asarray(j_sample(jnp.asarray(logits), jax.random.PRNGKey(uniforms_seed),
                            *map(jnp.asarray, (temp, top_k, top_p, min_p, pen, recent))))
    g = torch.Generator().manual_seed(uniforms_seed)
    u = torch.rand((B, CAND), generator=g)
    t = sample_tokens(torch.from_numpy(logits), u,
                      *map(torch.from_numpy, (temp, top_k, top_p, min_p, pen, recent)))
    assert t.dtype == torch.int32 and t.shape == (B,)
    return j, t.numpy()


@pytest.mark.parametrize("penalty", [1.0, 1.3, 0.7])
def test_greedy_matches_jax(penalty):
    for seed in range(3):
        j, t = _both(_inputs(seed, 0.0, 0, 1.0, 0.0, penalty))
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("corner", ["top_k_1", "tiny_top_p", "min_p_near_1",
                                    "penalty_under_top_k_1"])
def test_deterministic_corners_match_jax(corner):
    kw = {"top_k_1": (1.1, 1, 1.0, 0.0, 1.0),
          "tiny_top_p": (0.9, 0, 1e-6, 0.0, 1.0),
          "min_p_near_1": (1.0, 0, 1.0, 0.9999, 1.0),
          "penalty_under_top_k_1": (0.8, 1, 0.95, 0.05, 3.0)}[corner]
    for seed in range(3):
        args = _inputs(seed, *kw)
        j, t = _both(args, uniforms_seed=seed)
        np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(t, np.argmax(args[0], -1))


def test_stochastic_support_and_seed():
    """top_k 5 at temperature 1: every pick is one of the slot's 5 best
    logits, the same generator seed gives the same picks, and over many
    draws more than one candidate comes up."""
    logits, temp, top_k, top_p, min_p, pen, recent = _inputs(4, 1.0, 5, 1.0, 0.0, 1.0)
    top5 = np.argsort(-logits, -1)[:, :5]
    lt = torch.from_numpy(logits)
    rest = [torch.from_numpy(a) for a in (temp, top_k, top_p, min_p, pen, recent)]
    seen = set()
    for seed in range(40):
        picks = [sample_tokens(lt, torch.rand((B, CAND), generator=torch.Generator()
                                              .manual_seed(seed)), *rest).numpy()
                 for _ in range(2)]
        np.testing.assert_array_equal(picks[0], picks[1])
        assert all(picks[0][b] in top5[b] for b in range(B))
        seen.add(int(picks[0][0]))
    assert len(seen) > 1


def test_top_candidates_order_with_ties():
    """Descending values, equal values in ascending index order (the order
    of jax.lax.top_k)."""
    logits = np.round(np.random.default_rng(2).standard_normal((2, 600)), 1).astype(np.float32)
    vals, idx = top_candidates(torch.from_numpy(logits), 64)
    jv, ji = jax.lax.top_k(jnp.asarray(logits), 64)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.fixture(scope="module")
def tinydoc():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with open(os.path.join(FIX, "tinydoc_expected.json")) as f:
        expected = json.load(f)
    yield Engine.from_gguf(TINYDOC, max_seq=192, dtype=torch.float32, device="cpu"), expected
    torch.set_num_threads(n)


def test_generate_fused_matches_generate_and_jax(tinydoc):
    eng, expected = tinydoc
    je = JEngine.from_gguf(TINYDOC, max_seq=192, dtype=jnp.float32)
    prompt, want = next(iter(expected["greedy"].items()))
    n = min(len(want), 12)
    got = eng.generate_fused(prompt, n_predict=n, stop_on_eog=False, chunk=5)[1]
    assert got == eng.generate(prompt, n_predict=n, stop_on_eog=False)[1] == want[:n]
    n_past = eng.n_past
    jt = je.generate_fused(prompt, n_predict=n, sampler=JParams(greedy=True),
                           stop_on_eog=False, chunk=5)[1]
    assert got == jt
    assert n_past == je.n_past  # the same surplus rows rewound


def test_decode_fused_advances_cache(tinydoc):
    """decode_fused(tok, n) advances n_past by n and its tokens are those of
    n decode_one steps (tests/test_llama_parity.py's check)."""
    eng, _ = tinydoc
    prompt = eng.tokenizer.tokenize("The ", add_special=True)
    eng.reset()
    tok = int(np.argmax(eng.prefill(prompt)))
    ref, cur = [], tok
    for _ in range(6):
        cur = int(np.argmax(eng.decode_one(cur)))
        ref.append(cur)
    eng.reset()
    eng.prefill(prompt)
    assert eng.decode_fused(tok, n_steps=6) == ref
    assert eng.n_past == len(prompt) + 6 == int(eng.kv.n_past[0])


def test_generate_fused_stops_on_eog(tinydoc, monkeypatch):
    """A token the greedy run emits, declared end-of-generation, ends
    generate_fused where it ends generate, with the rows past it rewound."""
    eng, _ = tinydoc
    ids = eng.generate("The ", n_predict=10, stop_on_eog=False)[1]
    j = next(j for j in range(3, 10) if ids[j] not in ids[:j])
    monkeypatch.setattr(eng.tokenizer.vocab.special, "eog_ids", lambda: {ids[j]})
    want = eng.generate("The ", n_predict=10)[1]
    assert want == ids[:j]
    got = eng.generate_fused("The ", n_predict=10, chunk=4)[1]
    assert got == want
    n_prompt = len(eng.tokenizer.tokenize("The ", add_special=True, parse_special=True))
    assert eng.n_past == n_prompt + j == int(eng.kv.n_past[0])


def test_stochastic_fused_loop_seeded(tinydoc):
    """A stochastic sampler on the fused loop: the same seed gives the same
    tokens, and top_k 1 gives the greedy tokens."""
    eng, _ = tinydoc
    sp = SamplerParams(temp=0.9, top_k=8, top_p=0.95, min_p=0.05, seed=11,
                       penalty_repeat=1.1)
    a = eng.generate_fused("The ", n_predict=9, sampler=sp, stop_on_eog=False, chunk=4)[1]
    b = eng.generate_fused("The ", n_predict=9, sampler=sp, stop_on_eog=False, chunk=4)[1]
    assert a == b and len(a) == 9
    k1 = SamplerParams(temp=0.9, top_k=1, seed=3)
    greedy = eng.generate("The ", n_predict=9, stop_on_eog=False)[1]
    assert eng.generate_fused("The ", n_predict=9, sampler=k1, stop_on_eog=False,
                              chunk=4)[1] == greedy
