"""Port parity: the continuous-batching engine
(llama_cpp_gfx906_tpu_torch.runtime.batch_engine) against the JAX
package's BatchedEngine, on the CPU at f32.

Both engines serve the committed tinydoc fixture (real trained weights, so
greedy margins are wide) through the same script of requests, and must give
the same greedy tokens exactly, with the same slot choices, fill levels and
prompt-cache counts: three slots taking four prompts (one waits for a free
slot), prompts chunked 4 tokens at a time while other slots decode, a
prompt that extends an earlier one (prefix reuse), f32 and q8 caches, a
shared system prompt, and a q8 context shift.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama_cpp_gfx906_tpu.gguf import GGUFReader
from llama_cpp_gfx906_tpu.models.config import config_from_gguf
from llama_cpp_gfx906_tpu.runtime.batch_engine import BatchedEngine as JEngine
from llama_cpp_gfx906_tpu.runtime.batch_engine import SamplerConfig as JSampler
from llama_cpp_gfx906_tpu.runtime.weights import load_llama_params
from llama_cpp_gfx906_tpu.tokenizers import tokenizer_from_gguf
from llama_cpp_gfx906_tpu_torch.runtime.batch_engine import (BatchedEngine, SamplerConfig,
                                                             SlotState)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINYDOC = os.path.join(ROOT, "tests", "fixtures", "tinydoc-byte.f16.gguf")
TEXTS = ["The ", "# ", "quant", "tensor parallel"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_model():
    reader = GGUFReader(TINYDOC)
    cfg = config_from_gguf(reader)
    return cfg, load_llama_params(reader, cfg, jnp.float32), tokenizer_from_gguf(reader)


def engines(jax_model, **kw):
    cfg, params, tok = jax_model
    return (JEngine(cfg, params, tok, dtype=jnp.float32, **kw),
            BatchedEngine.from_gguf(TINYDOC, dtype=torch.float32, device="cpu", **kw))


def drive(eng, sampler_cls, requests, max_steps=200):
    """Feed ``requests`` [(prompt ids, n_predict)] in order, each as soon as a
    slot is free, step until all finish; returns the tokens per request and
    a log of (request, slot id, n_past at admission)."""
    todo = list(enumerate(requests))
    live, out, log = {}, {i: [] for i in range(len(requests))}, []
    for _ in range(max_steps):
        while todo:
            i, (ids, n) = todo[0]
            slot = eng.add_request(list(ids), n, sampler_cls(temp=0.0))
            if slot is None:
                break
            todo.pop(0)
            live[i] = slot
            log.append((i, slot.id, slot.n_past))
        for slot, tok, fin in eng.step():
            i = next(j for j, s in live.items() if s is slot)
            out[i].append(tok)
            if fin:
                eng.release(slot)
                del live[i]
        if not todo and not live:
            return out, log
    raise AssertionError("requests did not finish")


def ids_of(tok, text):
    return tok.tokenize(text, add_special=True, parse_special=True)


@pytest.mark.parametrize("kv", [None, "q8"])
def test_concurrent_chunked_prefix_reuse_match_jax(jax_model, kv):
    """Four prompts on three slots (the fourth waits), 4-token prefill chunks
    interleaved with decode, then a prompt extending the first request's
    prompt and output: the slot with that prefix is picked and its rows are
    reused."""
    tok = jax_model[2]
    first = [(ids_of(tok, t), n) for t, n in zip(TEXTS, (10, 6, 8, 7))]
    results = []
    for eng, sc in zip(engines(jax_model, n_slots=3, max_seq=96, n_chunk=4,
                               kv_cache_dtype=kv), (JSampler, SamplerConfig)):
        out, log = drive(eng, sc, first)
        follow = first[0][0] + out[0][:5] + ids_of(tok, "ok")[1:]
        out2, log2 = drive(eng, sc, [(follow, 6)])
        results.append((out, log, out2, log2, dict(eng.metrics)))
    (jo, jl, jo2, jl2, jm), (to, tl, to2, tl2, tm) = results
    assert to == jo and tl == jl
    assert to2 == jo2 and tl2 == jl2
    assert tl2[0][2] > 0  # rows reused from the cache
    for key in ("n_prompt_tokens", "n_prompt_tokens_cached", "n_generated_tokens",
                "n_requests"):
        assert tm[key] == jm[key], key
    if kv is None:
        assert to[0] == [13, 35, 35, 35, 35, 35, 35, 35, 229, 151]  # pinned


@pytest.mark.parametrize("kv", [None, "q8"])
def test_shared_system_prompt_matches_jax_and_unshared(jax_model, kv):
    """A system prompt prefilled once into the shared segment: the port and
    the JAX engine agree, and with an f32 cache (as tests/test_server.py:570
    holds for JAX) the outputs equal the unshared engine's on the full
    prompts."""
    tok = jax_model[2]
    sys_ids = ids_of(tok, "Shared doc: the")
    full = [(sys_ids + ids_of(tok, t)[1:], n) for t, n in zip(TEXTS[:3], (8, 6, 7))]
    jax_eng, eng = engines(jax_model, n_slots=3, max_seq=96, n_chunk=8,
                           kv_cache_dtype=kv)
    jax_eng.set_system_prompt(sys_ids)
    eng.set_system_prompt(sys_ids)
    want, jlog = drive(jax_eng, JSampler, full)
    got, log = drive(eng, SamplerConfig, full)
    assert got == want and log == jlog
    assert eng.kv.shared_k.shape[1:3] == (1, len(sys_ids))
    assert eng.kv.shared_k.dtype == torch.float32  # compute dtype beside q8 too
    assert eng.metrics["n_prompt_tokens_cached"] >= len(sys_ids) * len(full)
    if kv is None:  # a q8 cache would hold the unshared prompt rows in int8
        plain = BatchedEngine.from_gguf(TINYDOC, dtype=torch.float32, device="cpu",
                                        n_slots=3, max_seq=96, n_chunk=8)
        assert drive(plain, SamplerConfig, full)[0] == got


def test_q8_context_shift_matches_jax(jax_model):
    """A q8 slot that reaches max_seq shifts its context (K rows re-roped
    through f32 and requantized, V rows moved as int8) and goes on
    decoding, as the JAX engine does (after tests/test_kv_quant.py:106)."""
    tok = jax_model[2]
    prompt = ids_of(tok, "The quick brown fox jumps over it")[:24]
    outs = []
    for eng, sc in zip(engines(jax_model, n_slots=2, max_seq=32, kv_cache_dtype="q8"),
                       (JSampler, SamplerConfig)):
        slot = eng.add_request(prompt, n_predict=20, sampler=sc(temp=0.0))
        toks = []
        for _ in range(80):
            toks += [t for s, t, _ in eng.step() if s is slot]
            if slot.stop_reason is not None:
                break
        outs.append((toks, slot.n_shifted, slot.n_past))
    assert outs[0][1] > 0 and len(outs[0][0]) == 20
    assert outs[1] == outs[0]


def test_release_parks_idle_slot_past_its_prefix(jax_model):
    """Idle slots ride every decode step and write one dead row at their
    n_past: release parks it just past the cached prefix (JAX :1206), so
    the cached rows survive while another slot decodes."""
    eng = BatchedEngine.from_gguf(TINYDOC, dtype=torch.float32, device="cpu", n_slots=2,
                                  max_seq=64)
    tok = eng.tokenizer
    short, long_ = ids_of(tok, "quant"), ids_of(tok, "# ")
    a = eng.add_request(short, 2, SamplerConfig(temp=0.0))
    b = eng.add_request(long_, 12, SamplerConfig(temp=0.0))
    while a.stop_reason is None:
        eng.step()
    eng.release(a)
    keep = len(a.cache_tokens)
    assert keep == len(short) + 1 and eng.n_past_host[a.id] == keep
    rows = eng.kv.k[:, a.id, :keep].clone()
    while b.stop_reason is None:
        eng.step()
    assert torch.equal(eng.kv.k[:, a.id, :keep], rows)


def test_add_request_checks_its_input(jax_model):
    eng = BatchedEngine.from_gguf(TINYDOC, dtype=torch.float32, device="cpu", n_slots=1,
                                  max_seq=32, ctx_shift=False)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.add_request([], 4)
    with pytest.raises(ValueError, match="out of range"):
        eng.add_request([1, eng.cfg.n_vocab], 4)
    with pytest.raises(ValueError, match="max_seq"):
        eng.add_request([1] * 20, 20)
    with pytest.raises(ValueError, match="max_seq"):
        eng.add_request([1] * 40, 4, truncate=False)
    slot = eng.add_request(list(range(3, 43)), 4, n_keep=5)  # middle truncation
    assert slot.n_truncated == 40 - (32 - 4) and slot.prompt_ids[:5] == list(range(3, 8))
    assert eng.add_request([5, 6], 2) is None  # saturated
    with pytest.raises(RuntimeError, match="idle"):
        eng.set_system_prompt([1, 2])


def test_warmup_resets_metrics_and_captures_nothing_on_cpu(jax_model):
    eng = BatchedEngine.from_gguf(TINYDOC, dtype=torch.float32, device="cpu", n_slots=2,
                                  max_seq=32)
    eng.warmup()
    assert all(v == 0 for v in eng.metrics.values())
    assert not eng.busy and all(s.cache_tokens == [] for s in eng.slots)
    assert np.all(eng.n_past_host == 0)


def test_every_prefilling_slot_advances_one_chunk_per_step(jax_model):
    """A step runs one prompt chunk for every prefilling slot, then one
    decode step for the slots that have their first token; the engine
    counts both (the server's /metrics reports them)."""
    eng = BatchedEngine.from_gguf(TINYDOC, dtype=torch.float32, device="cpu", n_slots=3,
                                  max_seq=64, n_chunk=4)
    slots = [eng.add_request(list(range(3, 3 + n)), 3, SamplerConfig(temp=0.0))
             for n in (10, 5, 3)]  # 3, 2 and 1 chunks
    eng.step()
    assert [s.n_past for s in slots] == [4, 4, 4]  # the third also decoded
    assert [len(s.generated) for s in slots] == [0, 0, 2]
    assert (eng.metrics["n_prefill_chunks"], eng.metrics["n_decode_steps"]) == (3, 1)
    while any(s.stop_reason is None for s in slots):
        eng.step()
    assert eng.metrics["n_prefill_chunks"] == 6
    assert [len(s.generated) for s in slots] == [3, 3, 3]
