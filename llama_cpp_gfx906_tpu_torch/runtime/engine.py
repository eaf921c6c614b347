"""Single-stream inference engine: load -> prefill -> decode loop (port of
``llama_cpp_gfx906_tpu/runtime/engine.py``: ``from_gguf``, ``reset``,
``set_n_past``, ``prefill``, ``decode_one``, ``generate``, the fused
decode loop ``decode_fused`` / ``generate_fused``, and self-extend's
``seq_div`` / ``seq_add``).

PyTorch runs eagerly, so there are no shape buckets: prefill runs at the
prompt's own length.  The KV cache (bf16/f32, or q8 with
``kv_cache_dtype="q8"``) is updated in place.  The engine runs on the card
unless ``device="cpu"`` is passed.

The fused loop keeps decode on the device: one step (forward at T = 1,
on-device sampling, the recent-token ring) is captured once per engine in
a CUDA graph and replayed once per token; only the chunk's token ids come
back to the host.  On the CPU the same step runs in a Python loop.  The
captured step belongs to the cache's state: it is captured again once the
decode route or the cache's logical-position planes change (``seq_div`` /
``seq_add`` give the cache those planes, ``reset`` drops them).

Self-extend (grouped attention): ``seq_div`` / ``seq_add`` give every row
of the cache a logical position (``KVCache.pos``) and compress or shift a
range of them, re-roping the cached K rows by each row's change on the
device in one pass; later tokens are roped and masked at their logical
positions.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from ..gguf.reader import GGUFModelReader
from ..models.config import ModelConfig, config_from_gguf
from ..models.llama import POS_SENTINEL, KVCache, decode_route, forward
from ..ops.kv_quant import QuantKV, quantize_rows
from ..ops.rope import inv_freq_for, rope_shift_rows
from ..ops.sampling_ops import CAND, sample_tokens
from ..sampling.samplers import SamplerChain, SamplerParams
from ..tokenizers import Tokenizer, tokenizer_from_gguf
from .weights import load_llama_params, load_llama_params_quantized


@dataclass
class PerfCounters:
    """Host-clock timings; each step ends in a device-to-host copy of the
    logits, so the times include the device work."""

    t_load_s: float = 0.0
    t_prefill_s: float = 0.0
    t_decode_s: float = 0.0
    n_prefill: int = 0
    n_decode: int = 0

    def summary(self) -> dict:
        return {
            "load_s": self.t_load_s,
            "prefill_tok_s": self.n_prefill / self.t_prefill_s if self.t_prefill_s else 0.0,
            "decode_tok_s": self.n_decode / self.t_decode_s if self.t_decode_s else 0.0,
            "n_prefill": self.n_prefill,
            "n_decode": self.n_decode,
        }


RECENT = 64  # the recent-token ring of the on-device repetition penalty


def load_model(path: str, dtype: torch.dtype, device: torch.device,
               keep_quantized: bool = True):
    """(cfg, params, tokenizer) of a llama GGUF, the weights on ``device``
    (see :meth:`Engine.from_gguf` for ``keep_quantized``)."""
    reader = GGUFModelReader(path)
    cfg = config_from_gguf(reader)
    tok = tokenizer_from_gguf(reader)
    if keep_quantized:
        params = load_llama_params_quantized(reader, cfg, dtype, device)
    else:
        params = load_llama_params(reader, cfg, dtype, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return cfg, params, tok


def sample_one(logits: np.ndarray, sp: SamplerParams, prev: list[int],
               gen: torch.Generator, device) -> int:
    """One token from host logits (V,) through the on-device sampler, the
    repetition penalty over the last ``RECENT`` of ``prev``."""
    recent = np.full((1, RECENT), -1, np.int32)
    if prev and sp.penalty_repeat != 1.0:
        tail = prev[-RECENT:]
        recent[0, -len(tail):] = tail
    vec = lambda v, dt: torch.full((1,), v, dtype=dt, device=device)  # noqa: E731
    u = torch.rand((1, CAND), generator=gen, device=device)
    tok = sample_tokens(
        torch.from_numpy(logits[None]).to(device), u,
        vec(sp.temp, torch.float32), vec(sp.top_k, torch.int32),
        vec(sp.top_p, torch.float32), vec(sp.min_p, torch.float32),
        vec(sp.penalty_repeat, torch.float32),
        torch.from_numpy(recent).to(device))
    return int(tok[0])


class _FusedLoop:
    """Static buffers of the fused decode loop: a captured step reads and
    writes only these, at fixed addresses."""

    def __init__(self, steps: int, dev):
        i32 = dict(dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        self.steps = steps
        self.tok = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.recent = torch.full((1, RECENT), -1, **i32)
        self.temp = torch.zeros((1,), **f32)
        self.top_k = torch.zeros((1,), **i32)
        self.top_p = torch.ones((1,), **f32)
        self.min_p = torch.zeros((1,), **f32)
        self.penalty = torch.ones((1,), **f32)
        self.uniforms = torch.zeros((steps, 1, CAND), **f32)
        self.out = torch.zeros((steps,), **i32)
        self.i = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.graph = None
        self.key = None  # the route and cache state the graph was captured on


@dataclass
class Engine:
    cfg: ModelConfig
    params: torch.nn.Module
    tokenizer: Tokenizer
    device: torch.device
    max_seq: int = 2048
    kv_dtype: torch.dtype | str = torch.bfloat16  # or "q8"
    perf: PerfCounters = field(default_factory=PerfCounters)

    def __post_init__(self):
        self.reset()

    @classmethod
    def from_gguf(cls, path: str, max_seq: int = 2048,
                  dtype: torch.dtype = torch.bfloat16, device=None,
                  keep_quantized: bool = True,
                  kv_cache_dtype: str | torch.dtype | None = None) -> "Engine":
        """Load a llama GGUF; weights and the KV cache in ``dtype``, or the
        cache in ``kv_cache_dtype`` ("q8": int8 rows and per-row scales).
        ``keep_quantized`` keeps supported quant types block-quantized on
        the device (nib4c for the Q4 family, int8 otherwise, folded k-quant
        scales); off, every weight is dequantized to ``dtype``.  With a q8
        cache, single-token decode takes the per-layer loop: the K6/K7
        gates refuse it, as in the JAX package."""
        dev = resolve_device(device)
        t0 = time.perf_counter()
        cfg, params, tok = load_model(path, dtype, dev, keep_quantized)
        eng = cls(cfg=cfg, params=params, tokenizer=tok, device=dev,
                  max_seq=max_seq, kv_dtype=kv_cache_dtype or dtype)
        eng.perf.t_load_s = time.perf_counter() - t0
        return eng

    def reset(self) -> None:
        """Empty the cache and drop its logical positions, as a fresh JAX
        cache has none.  Its K/V buffers are kept (rows past n_past are never
        read), so a decode step captured without positions stays valid."""
        if getattr(self, "kv", None) is None:
            self.kv = KVCache.create(self.cfg, 1, self.max_seq, self.kv_dtype,
                                     self.device)
            self._fused = None
            decode_route(self.params, self.cfg, self.kv)
        self.set_n_past(0)

    def set_n_past(self, n: int) -> None:
        """Rewind (or advance) the sequence position; rows past ``n`` are
        dead and are overwritten by later writes.  At 0 the logical
        positions go (``reset``); otherwise rows past ``n`` take the
        sentinel and the next position follows the last live row's."""
        self.kv.n_past.fill_(n)
        self._n_past = n
        if self.kv.pos is None:
            return
        if n == 0:
            self.kv.pos = self.kv.pos_next = None
            return
        live = self._live()
        self.kv.pos.masked_fill_(~live, POS_SENTINEL)
        self.kv.pos_next.copy_(self.kv.pos.masked_fill(~live, -1).amax(1) + 1)

    # -- self-extend / grouped attention (JAX seq_div / seq_add) -------------

    def _live(self) -> torch.Tensor:
        """(B, S) bool: the rows below the fill level."""
        return (torch.arange(self.max_seq, device=self.device)[None, :]
                < self.kv.n_past[:, None])

    def _ensure_pos(self) -> None:
        """Give the cache logical positions, the rows' own where it has none
        (the sentinel past the fill level)."""
        if self.kv.pos is not None:
            return
        rows = torch.arange(self.max_seq, dtype=torch.int32, device=self.device)
        self.kv.pos = torch.where(self._live(), rows[None, :], POS_SENTINEL)
        self.kv.pos = self.kv.pos.to(torch.int32).contiguous()
        self.kv.pos_next = self.kv.n_past.clone()

    def _move_positions(self, p0: int, p1: int, new_pos_fn) -> None:
        """Positions in [p0, p1) become ``new_pos_fn(pos)``; the cached K
        rows are re-roped by each row's change, in place, on the device (a
        q8 cache's K rows round-trip through f32, as the context shift's)."""
        if self.cfg.pos_emb != "rope":
            raise ValueError("seq_div / seq_add need a rope attention cache")
        self._ensure_pos()
        pos = self.kv.pos
        in_range = (pos >= p0) & (pos < p1)
        new_pos = torch.where(in_range, new_pos_fn(pos), pos).to(torch.int32)
        deltas = (new_pos - pos).masked_fill(~in_range, 0)
        inv_freq = inv_freq_for(self.cfg, self.device)
        with torch.inference_mode():
            if isinstance(self.kv.k, QuantKV):
                kf = self.kv.k.q.float() * self.kv.k.s
                k2 = quantize_rows(rope_shift_rows(kf, deltas, inv_freq,
                                                   self.cfg.rope_interleaved))
                self.kv.k.q.copy_(k2.q)
                self.kv.k.s.copy_(k2.s)
            else:
                self.kv.k.copy_(rope_shift_rows(self.kv.k, deltas, inv_freq,
                                                self.cfg.rope_interleaved))
            pos.copy_(new_pos)
            self.kv.pos_next.copy_(new_pos.masked_fill(~self._live(), -1).amax(1) + 1)

    def seq_div(self, p0: int, p1: int, g: int) -> None:
        """Compress the logical positions in [p0, p1) by ``g``:
        p -> p0 + (p - p0) // g (self-extend; JAX ``Engine.seq_div``)."""
        self._move_positions(p0, p1, lambda pos: p0 + torch.div(
            pos - p0, g, rounding_mode="floor"))

    def seq_add(self, p0: int, p1: int, delta: int) -> None:
        """Shift the logical positions in [p0, p1) by ``delta`` (JAX
        ``Engine.seq_add``)."""
        self._move_positions(p0, p1, lambda pos: pos + delta)

    @property
    def n_past(self) -> int:
        return self._n_past

    def _step(self, toks: np.ndarray) -> np.ndarray:
        if self._n_past + toks.shape[1] > self.max_seq:
            raise ValueError(f"{self._n_past} + {toks.shape[1]} tokens exceed "
                             f"max_seq {self.max_seq}")
        with torch.inference_mode():
            logits, self.kv = forward(
                self.params, self.cfg,
                torch.from_numpy(toks).to(self.device), self.kv, last_only=True)
            out = logits[0, -1].cpu().numpy()
        self._n_past += toks.shape[1]
        return out

    def prefill(self, token_ids: list[int]) -> np.ndarray:
        """Run the prompt through; returns last-token logits (V,)."""
        t0 = time.perf_counter()
        out = self._step(np.asarray([token_ids], np.int64))
        self.perf.t_prefill_s += time.perf_counter() - t0
        self.perf.n_prefill += len(token_ids)
        return out

    def decode_one(self, token_id: int) -> np.ndarray:
        """Advance one token; returns next-token logits (V,)."""
        t0 = time.perf_counter()
        out = self._step(np.asarray([[token_id]], np.int64))
        self.perf.t_decode_s += time.perf_counter() - t0
        self.perf.n_decode += 1
        return out

    # -- fused multi-token decode (device-side sampling loop) ---------------

    def _fused_step(self, st: _FusedLoop) -> None:
        logits, _ = forward(self.params, self.cfg, st.tok[:, None], self.kv,
                            last_only=True)
        u = st.uniforms.index_select(0, st.i).reshape(1, CAND)
        nxt = sample_tokens(logits[:, 0], u, st.temp, st.top_k, st.top_p,
                            st.min_p, st.penalty, st.recent)
        st.recent.copy_(torch.cat([st.recent[:, 1:], nxt[:, None]], 1))
        st.out.index_copy_(0, st.i, nxt)
        st.tok.copy_(nxt)
        st.i += 1

    def _graph_key(self) -> tuple:
        """What a captured step depends on beyond its static buffers: the
        decode route and the addresses of the cache's position planes."""
        kv = self.kv
        planes = (None if kv.pos is None
                  else (kv.pos.data_ptr(), kv.pos_next.data_ptr()))
        return decode_route(self.params, self.cfg, kv), planes

    def _graph_stale(self, st: _FusedLoop) -> bool:
        return st.graph is None or st.key != self._graph_key()

    def _capture(self, st: _FusedLoop) -> None:
        """Warm one step up eagerly (builds and loads the kernels), rewind
        it, then capture the step.  A capture launches nothing, so the
        launch counts are restored after it; replays do not pass through
        the wrappers and are not counted (a profiler trace sees them)."""
        n0 = self._n_past
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._fused_step(st)
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.set_n_past(n0)
        before = kernels.counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._fused_step(st)
        kernels.set_counts(before)
        st.graph, st.key = graph, self._graph_key()

    def decode_fused(self, token_id: int, n_steps: int = 32,
                     sampler: SamplerParams | None = None,
                     recent_ids: list[int] | None = None,
                     generator: torch.Generator | None = None) -> list[int]:
        """Feed ``token_id`` and decode ``n_steps`` tokens on the device
        (sampling included); advances the cache by ``n_steps`` and returns
        the sampled ids.  The Gumbel noise of a stochastic ``sampler`` is
        drawn from ``generator`` (default: one seeded from ``sampler.seed``)
        before the steps run."""
        sp = sampler or SamplerParams(greedy=True)
        greedy = sp.greedy or sp.temp <= 0
        if self._n_past + n_steps > self.max_seq:
            raise ValueError(f"{self._n_past} + {n_steps} tokens exceed "
                             f"max_seq {self.max_seq}")
        st = self._fused
        if st is None or st.steps < n_steps:
            st = self._fused = _FusedLoop(max(n_steps, 32), self.device)
        recent = np.full((1, RECENT), -1, np.int32)
        if recent_ids and sp.penalty_repeat != 1.0:
            tail = list(recent_ids)[-RECENT:]
            recent[0, -len(tail):] = tail
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(
                sp.seed if sp.seed != 0xFFFFFFFF else 0)
        t0 = time.perf_counter()
        with torch.inference_mode():
            if self.device.type == "cuda" and self._graph_stale(st):
                self._capture(st)
            st.tok.fill_(token_id)
            st.recent.copy_(torch.from_numpy(recent))
            st.temp.fill_(0.0 if greedy else sp.temp)
            st.top_k.fill_(0 if greedy else sp.top_k)
            st.top_p.fill_(1.0 if greedy else sp.top_p)
            st.min_p.fill_(0.0 if greedy else sp.min_p)
            st.penalty.fill_(sp.penalty_repeat)
            st.i.zero_()
            torch.rand(st.uniforms.shape, generator=generator,
                       device=self.device, out=st.uniforms)
            if self.device.type == "cuda":
                for _ in range(n_steps):
                    st.graph.replay()
            else:
                for _ in range(n_steps):
                    self._fused_step(st)
            out = st.out[:n_steps].tolist()
        self._n_past += n_steps
        self.perf.t_decode_s += time.perf_counter() - t0
        self.perf.n_decode += n_steps
        return out

    def generate_fused(self, prompt: str, n_predict: int = 64,
                       sampler: SamplerParams | None = None,
                       stop_on_eog: bool = True,
                       chunk: int = 32) -> tuple[str, list[int]]:
        """``generate`` on the fused decode path: one chunk of ``chunk``
        tokens per host round trip.  EOG is checked on the host between
        chunks; the KV rows decoded past the stop point are rewound.  The
        first token is sampled from the prefill logits on the host when the
        sampler is greedy, else on the device (the port's host chain is
        greedy only)."""
        sp = sampler or SamplerParams(greedy=True)
        greedy = sp.greedy or sp.temp <= 0
        ids = self.tokenizer.tokenize(prompt, add_special=True, parse_special=True)
        if len(ids) + n_predict > self.max_seq:
            raise ValueError(f"prompt ({len(ids)}) + n_predict ({n_predict}) "
                             f"exceeds max_seq {self.max_seq}")
        self.reset()
        logits = self.prefill(ids)
        gen = torch.Generator(self.device).manual_seed(
            sp.seed if sp.seed != 0xFFFFFFFF else 0)
        if greedy:
            first = SamplerChain(sp, self.cfg.n_vocab).sample(logits, ids)
        else:
            first = self._sample_first(logits, sp, ids, gen)
        eog = self.tokenizer.vocab.special.eog_ids()
        out_ids: list[int] = [first]
        if stop_on_eog and first in eog:
            return "", []
        while len(out_ids) < n_predict:
            n_before = self._n_past
            toks = self.decode_fused(out_ids[-1], n_steps=chunk, sampler=sp,
                                     recent_ids=ids + out_ids, generator=gen)
            stop_j = None
            for j, t in enumerate(toks):
                if (stop_on_eog and t in eog) or len(out_ids) + j + 1 > n_predict:
                    stop_j = j
                    break
            if stop_j is not None:
                kept = toks[:stop_j]
                # feeds consumed: the fed token + kept; rewind the surplus rows
                self.set_n_past(n_before + 1 + len(kept))
                if stop_on_eog and toks[stop_j] in eog:
                    out_ids.extend(kept)
                    break
                toks = kept
            out_ids.extend(toks)
        out_ids = out_ids[:n_predict]
        return self.tokenizer.detokenize(out_ids), out_ids

    def _sample_first(self, logits: np.ndarray, sp: SamplerParams,
                      prev: list[int], gen: torch.Generator) -> int:
        """One token from host logits through the on-device sampler."""
        return sample_one(logits, sp, prev, gen, self.device)

    def generate(self, prompt: str, n_predict: int = 64,
                 sampler: SamplerParams | SamplerChain | None = None,
                 stop_on_eog: bool = True) -> tuple[str, list[int]]:
        chain = (sampler if isinstance(sampler, SamplerChain) else
                 SamplerChain(sampler or SamplerParams(greedy=True),
                              self.cfg.n_vocab))
        ids = self.tokenizer.tokenize(prompt, add_special=True, parse_special=True)
        if len(ids) + n_predict > self.max_seq:
            raise ValueError(f"prompt ({len(ids)}) + n_predict ({n_predict}) "
                             f"exceeds max_seq {self.max_seq}")
        self.reset()
        logits = self.prefill(ids)
        out_ids: list[int] = []
        all_ids = list(ids)
        eog = self.tokenizer.vocab.special.eog_ids()
        for _ in range(n_predict):
            tok = chain.sample(logits, all_ids)
            chain.accept(tok, is_eog=tok in eog)
            if stop_on_eog and tok in eog:
                break
            out_ids.append(tok)
            all_ids.append(tok)
            logits = self.decode_one(tok)
        return self.tokenizer.detokenize(out_ids), out_ids
