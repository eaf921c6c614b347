"""Continuous-batching inference engine, the server's backend (port of
``llama_cpp_gfx906_tpu/runtime/batch_engine.py``: slots, the shared
system-prompt segment, prefix-cache slot choice, chunked prefill, the
context shift, plain batched decode with on-device
sampling, release and warmup; no speculative decoding, grammar, logprobs,
LoRA, multimodal prompts or slot state files).

- N slots share one batched KV cache (L, N, S, Hkv, Dh), bf16/f32 or q8;
  each slot advances at its own ``n_past``.
- A prompt prefills in chunks of at most ``n_chunk`` tokens on the JAX
  package's chunk grid, each chunk a forward over the slot's contiguous
  view of the cache (written in place); every prefilling slot advances one
  chunk per step.
- One decode step advances every slot in a single (N, 1) forward, then
  samples on the device (``ops/sampling_ops.sample_tokens``) and shifts the
  recent-token ring; only the N token ids come back to the host.  On the
  card that step is captured once in a CUDA graph and replayed; its inputs
  are static device buffers the host fills before each replay.  Idle slots
  ride along and write one dead row each at their parked ``n_past``.
- A system prompt (:meth:`BatchedEngine.set_system_prompt`) is prefilled
  once into a shared segment (L, 1, S0, Hkv, Dh) in the compute dtype that
  every slot attends before its own rows; prompts that start with it skip
  its tokens.

The engine runs on the card unless ``device="cpu"`` is passed; on the CPU
the decode step runs eagerly.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.llama import KVCache, forward
from ..ops.kv_quant import QuantKV, quantize_rows, take_rows
from ..ops.rope import inv_freq_for, rope_shift_rows
from ..ops.sampling_ops import CAND, sample_tokens
from ..sampling.samplers import SamplerChain, SamplerParams
from .engine import RECENT, load_model, sample_one


class SlotState(enum.Enum):
    IDLE = 0
    GENERATING = 1
    PREFILLING = 2  # prompt chunks still streaming in


@dataclass
class SamplerConfig:
    temp: float = 0.8
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.05
    penalty_repeat: float = 1.0
    seed: int | None = None


@dataclass
class Slot:
    id: int
    state: SlotState = SlotState.IDLE
    request_id: str = ""
    prompt_ids: list[int] = field(default_factory=list)
    generated: list[int] = field(default_factory=list)
    n_predict: int = 0
    n_past: int = 0  # own rows only: a shared segment is not counted
    current_token: int = 0
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    stop_reason: str | None = None
    t_start: float = 0.0
    t_first_token: float = 0.0
    # prompt cache: tokens whose K/V rows survive in this slot after release
    cache_tokens: list[int] = field(default_factory=list)
    pending: list[int] = field(default_factory=list)  # prompt not yet run
    no_cache: bool = False  # rows not reusable by token identity (warmup)
    n_keep: int = 0  # context-shift anchor
    n_shifted: int = 0  # tokens discarded by context shifts
    n_truncated: int = 0  # prompt tokens dropped at admission
    gen: torch.Generator | None = None  # a seeded request's own uniforms

    def reset(self):
        self.state = SlotState.IDLE
        self.request_id = ""
        # only rows [0, n_past) hold K/V (the last sampled token was never
        # forwarded); a shifted context no longer maps rows to tokens
        if self.n_shifted or self.no_cache:
            self.cache_tokens = []
        else:
            self.cache_tokens = (self.prompt_ids + self.generated)[: self.n_past]
        self.no_cache = False
        self.prompt_ids = []
        self.generated = []
        self.pending = []
        self.n_past = 0
        self.n_keep = 0
        self.n_shifted = 0
        self.n_truncated = 0
        self.stop_reason = None
        self.gen = None


class _DecodeStep:
    """Static buffers of the batched decode step: a captured step reads and
    writes only these (and the cache), at fixed addresses."""

    def __init__(self, n: int, dev):
        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        self.tokens = torch.zeros((n, 1), dtype=torch.int64, device=dev)
        self.temp = torch.zeros((n,), **f32)
        self.top_k = torch.full((n,), CAND, **i32)
        self.top_p = torch.ones((n,), **f32)
        self.min_p = torch.zeros((n,), **f32)
        self.penalty = torch.ones((n,), **f32)
        self.uniforms = torch.full((n, CAND), 0.5, **f32)
        self.recent = torch.full((n, RECENT), -1, **i32)
        self.out = torch.zeros((n,), **i32)
        self.graph = None
        # bracket each replay on the card: the step's device time
        self.events = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
                       if dev.type == "cuda" else None)


class BatchedEngine:
    def __init__(self, cfg: ModelConfig, params, tokenizer, n_slots: int = 8,
                 max_seq: int = 2048, dtype=torch.bfloat16, seed: int = 0,
                 n_chunk: int = 256, ctx_shift: bool = True,
                 kv_cache_dtype=None, device=None):
        """``params`` on ``device`` (default: the card); ``kv_cache_dtype``
        None (the compute ``dtype``), a torch dtype or "q8"; ``n_chunk``
        prompt tokens per prefill chunk (the server's ``-b``)."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.dtype = dtype
        self.slots = [Slot(i) for i in range(n_slots)]
        self.n_chunk = n_chunk
        self.ctx_shift = ctx_shift
        self.kv = KVCache.create(cfg, n_slots, max_seq, kv_cache_dtype or dtype,
                                 self.device)
        self.system_ids: list[int] = []
        self.n_past_host = np.zeros(n_slots, np.int32)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self._step = _DecodeStep(n_slots, self.device)
        self.metrics = {
            "n_prompt_tokens": 0,
            "n_prompt_tokens_cached": 0,
            "n_generated_tokens": 0,
            "t_prefill_s": 0.0,
            "t_decode_s": 0.0,
            "t_decode_device_s": 0.0,  # replays' device time (card only)
            "n_decode_steps": 0,
            "n_prefill_chunks": 0,
            "n_requests": 0,
        }

    @classmethod
    def from_gguf(cls, path: str, dtype=torch.bfloat16, device=None, **kw
                  ) -> "BatchedEngine":
        """Load a llama GGUF (weights kept quantized, as ``Engine``) and
        build the engine; ``kw`` as the constructor."""
        dev = resolve_device(device)
        cfg, params, tok = load_model(path, dtype, dev)
        return cls(cfg, params, tok, dtype=dtype, device=dev, **kw)

    # -- shared-prefix (cross-slot) KV ----------------------------------------

    def set_system_prompt(self, ids: list[int]) -> None:
        """Prefill a shared prompt once and attend it from every slot; its
        rows are stored once, in the compute dtype (also beside a q8
        cache).  All slots must be idle.  An empty list removes it."""
        if any(s.state != SlotState.IDLE for s in self.slots):
            raise RuntimeError("set_system_prompt requires all slots idle")
        self._check_ids(ids)
        self.kv.shared_k = self.kv.shared_v = None
        self.system_ids = []
        if ids:
            seg = KVCache.create(self.cfg, 1, len(ids), self.dtype, self.device)
            with torch.inference_mode():
                forward(self.params, self.cfg,
                        torch.tensor([ids], device=self.device), seg, last_only=True)
            self.kv.shared_k, self.kv.shared_v = seg.k, seg.v
            self.system_ids = list(ids)
        self._step.graph = None  # the step's route and inputs changed
        for s in self.slots:
            s.cache_tokens = []  # old per-slot caches used other positions

    # -- slot management ------------------------------------------------------

    def free_slot(self) -> Slot | None:
        for s in self.slots:
            if s.state == SlotState.IDLE:
                return s
        return None

    def _pick_slot(self, prompt_ids: list[int]) -> tuple[Slot | None, int]:
        """The idle slot with the longest cached common prefix."""
        best, best_m = None, -1
        for s in self.slots:
            if s.state != SlotState.IDLE:
                continue
            m = 0
            limit = min(len(s.cache_tokens), len(prompt_ids) - 1)
            while m < limit and s.cache_tokens[m] == prompt_ids[m]:
                m += 1
            if m > best_m:
                best, best_m = s, m
        return best, max(best_m, 0)

    @property
    def n_active(self) -> int:
        return sum(s.state == SlotState.GENERATING for s in self.slots)

    @property
    def busy(self) -> bool:
        """Any slot still prefilling or generating."""
        return any(s.state != SlotState.IDLE for s in self.slots)

    def _check_ids(self, ids) -> None:
        bad = [t for t in ids if not 0 <= t < self.cfg.n_vocab]
        if bad:
            raise ValueError(f"token ids out of range [0, {self.cfg.n_vocab}): {bad[:8]}")

    def add_request(self, prompt_ids: list[int], n_predict: int,
                    sampler: SamplerConfig | None = None, request_id: str = "",
                    n_keep: int = 0, truncate: bool = True) -> Slot | None:
        """Assign a prompt to a free slot; returns None when every slot is
        busy.  The prompt prefills in chunks from :meth:`step`, after the
        rows the slot already holds for its longest cached prefix."""
        prompt_ids = [int(t) for t in prompt_ids]
        if not prompt_ids:
            raise ValueError("empty prompt")
        self._check_ids(prompt_ids)
        unbounded = n_predict <= 0  # -1: until the context or a stop
        if unbounded:
            n_predict = self.max_seq
        n_sys = len(self.system_ids)
        if n_sys and prompt_ids[:n_sys] == self.system_ids and len(prompt_ids) > n_sys:
            # the shared segment holds these rows: no prefill, no storage
            prompt_ids = prompt_ids[n_sys:]
            self.metrics["n_prompt_tokens_cached"] += n_sys
            self.metrics["n_prompt_tokens"] += n_sys
        slot, n_match = self._pick_slot(prompt_ids)
        if slot is None:
            return None
        n_truncated = 0
        if len(prompt_ids) >= self.max_seq:
            if not truncate:
                raise ValueError(f"prompt ({len(prompt_ids)}) >= max_seq {self.max_seq}")
            # keep n_keep head tokens and the newest tail, leaving room to
            # generate; n_keep is clamped below the target
            room = max(1, min(n_predict, self.max_seq // 4))
            target = self.max_seq - room
            keep = min(n_keep, max(target - 1, 0))
            head = prompt_ids[:keep]
            tail = prompt_ids[-(target - keep):]
            n_truncated = len(prompt_ids) - len(head) - len(tail)
            prompt_ids = head + tail
            n_match = min(n_match, keep)
        elif (len(prompt_ids) + n_predict > self.max_seq
              and not self.ctx_shift and not unbounded):
            raise ValueError(f"prompt ({len(prompt_ids)}) + n_predict ({n_predict}) "
                             f"> max_seq {self.max_seq}")
        slot.state = SlotState.PREFILLING
        slot.request_id = request_id
        slot.prompt_ids = list(prompt_ids)
        slot.generated = []
        slot.pending = prompt_ids[n_match:]
        slot.n_predict = n_predict
        slot.n_past = n_match
        slot.n_keep = n_keep
        slot.n_shifted = 0
        slot.n_truncated = n_truncated
        slot.no_cache = False
        slot.sampler = sampler or SamplerConfig()
        slot.gen = None
        if slot.sampler.seed is not None:
            slot.gen = torch.Generator(self.device).manual_seed(slot.sampler.seed)
        slot.stop_reason = None
        slot.t_start = time.perf_counter()
        self.n_past_host[slot.id] = n_match
        self.metrics["n_prompt_tokens_cached"] += n_match
        self.metrics["n_prompt_tokens"] += len(prompt_ids)
        self.metrics["n_requests"] += 1
        return slot

    # -- prefill --------------------------------------------------------------

    def _advance_prefill(self) -> list[tuple[Slot, int, bool]]:
        """One chunk for every prefilling slot."""
        out: list[tuple[Slot, int, bool]] = []
        for slot in self.slots:
            if slot.state == SlotState.PREFILLING:
                out.extend(self._prefill_one(slot))
        return out

    def _slot_view(self, slot: Slot) -> KVCache:
        """The slot's rows of the batched cache (views, written in place),
        with the shared segment."""
        s = slice(slot.id, slot.id + 1)
        return KVCache(k=self.kv.k[:, s], v=self.kv.v[:, s],
                       n_past=torch.tensor([slot.n_past], dtype=torch.int32,
                                           device=self.device),
                       shared_k=self.kv.shared_k, shared_v=self.kv.shared_v)

    def _prefill_one(self, slot: Slot) -> list[tuple[Slot, int, bool]]:
        """One prompt chunk for ``slot``; returns its first token's result
        once the prompt is done."""
        t0 = time.perf_counter()
        # after a cached prefix, the first chunk ends on the n_chunk grid
        take = min(self.n_chunk - slot.n_past % self.n_chunk, len(slot.pending))
        chunk = slot.pending[:take]
        ns = len(chunk)
        with torch.inference_mode():
            logits, _ = forward(self.params, self.cfg,
                                torch.tensor([chunk], device=self.device),
                                self._slot_view(slot), last_only=True)
            last = logits[0, -1].cpu().numpy() if len(slot.pending) == ns else None
            if last is None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # the chunk's time is its own
        slot.pending = slot.pending[ns:]
        slot.n_past += ns
        self.n_past_host[slot.id] = slot.n_past
        self.metrics["t_prefill_s"] += time.perf_counter() - t0
        self.metrics["n_prefill_chunks"] += 1
        if slot.pending:
            return []
        first = self._sample_first(last, slot)
        slot.state = SlotState.GENERATING
        slot.generated = [first]
        slot.current_token = first
        slot.t_first_token = time.perf_counter()
        row = np.full(RECENT, -1, np.int32)
        tail = (slot.prompt_ids + [first])[-RECENT:]
        row[-len(tail):] = tail
        self._step.recent[slot.id].copy_(torch.from_numpy(row))
        self.metrics["n_generated_tokens"] += 1
        return [(slot, first, self._check_finished(slot, first))]

    def _sample_first(self, logits: np.ndarray, slot: Slot) -> int:
        """The first token from the prompt's last logits: the greedy host
        chain (with its repetition penalty) when the sampler is greedy, else
        the on-device sampler, on the request's own generator when it carries
        a seed."""
        sc = slot.sampler
        if sc.temp <= 0:
            sp = SamplerParams(greedy=True, penalty_repeat=sc.penalty_repeat)
            return SamplerChain(sp, self.cfg.n_vocab).sample(logits, slot.prompt_ids)
        gen = slot.gen or self.generator
        sp = SamplerParams(temp=sc.temp, top_k=self._top_k(sc), top_p=sc.top_p,
                           min_p=sc.min_p, penalty_repeat=sc.penalty_repeat)
        return sample_one(logits, sp, slot.prompt_ids, gen, self.device)

    @staticmethod
    def _top_k(sc: SamplerConfig) -> int:
        return min(sc.top_k, CAND) if sc.top_k > 0 else CAND

    # -- context shift --------------------------------------------------------

    def _maybe_shift(self, slot: Slot) -> None:
        """Context shift when the slot is about to overflow: keep n_keep
        rows, drop half of the rest, slide the tail left and re-rope the
        moved keys (q8 K rows round-trip through f32 for the re-rope; V rows
        move as int8 and scale).  A model without rope (the ALiBi families)
        keeps its K rows unrotated, as JAX's shift does: ALiBi reads only
        the rows' new distances."""
        n_discard = max((slot.n_past - slot.n_keep) // 2, 1)
        keep, S = slot.n_keep, self.max_seq
        dev = self.device
        rows = torch.arange(S, device=dev)
        src = torch.where(rows < keep, rows, torch.clamp(rows + n_discard, max=S - 1))
        moved = (rows >= keep) & (rows < slot.n_past - n_discard)
        deltas = torch.where(moved, -n_discard, 0)[None]  # (1, S)
        inv_freq = inv_freq_for(self.cfg, dev)
        rope = self.cfg.pos_emb == "rope"
        i = slot.id
        with torch.inference_mode():
            if isinstance(self.kv.k, QuantKV):
                kq = take_rows(self.kv.k[:, i], src, 1)
                kf = kq.q.float() * kq.s
                if rope:
                    kf = rope_shift_rows(kf[:, None], deltas, inv_freq,
                                         self.cfg.rope_interleaved)[:, 0]
                k2 = quantize_rows(kf)
                v2 = take_rows(self.kv.v[:, i], src, 1)
                for plane, new in ((self.kv.k.q, k2.q), (self.kv.k.s, k2.s),
                                   (self.kv.v.q, v2.q), (self.kv.v.s, v2.s)):
                    plane[:, i].copy_(new)
            else:
                k2 = self.kv.k[:, i].index_select(1, src)
                if rope:
                    k2 = rope_shift_rows(k2[:, None], deltas, inv_freq,
                                         self.cfg.rope_interleaved)[:, 0]
                self.kv.k[:, i].copy_(k2)
                self.kv.v[:, i].copy_(self.kv.v[:, i].index_select(1, src))
        slot.n_past -= n_discard
        slot.n_shifted += n_discard
        self.n_past_host[slot.id] = slot.n_past

    def _check_finished(self, slot: Slot, token: int) -> bool:
        eog = self.tokenizer.vocab.special.eog_ids()
        if token in eog:
            slot.stop_reason = "stop"
        elif len(slot.generated) >= slot.n_predict:
            slot.stop_reason = "length"
        elif slot.n_past + 1 >= self.max_seq and not self.ctx_shift:
            slot.stop_reason = "length"
        return slot.stop_reason is not None

    # -- decode ---------------------------------------------------------------

    def _decode_step(self) -> None:
        """Forward at T = 1 over every slot, on-device sampling, the recent
        ring; reads and writes only the static buffers and the cache."""
        st = self._step
        logits, _ = forward(self.params, self.cfg, st.tokens, self.kv, last_only=True)
        nxt = sample_tokens(logits[:, 0], st.uniforms, st.temp, st.top_k, st.top_p,
                            st.min_p, st.penalty, st.recent)
        st.recent.copy_(torch.cat([st.recent[:, 1:], nxt[:, None]], 1))
        st.out.copy_(nxt)

    def _capture(self) -> None:
        """With the inputs of the coming step in place, warm one step up
        eagerly on a side stream (builds and loads the kernels, the decode
        route and its workspaces; it writes the same cache rows as the step
        will), undo what it changed in the ring and in ``n_past``, then
        capture the step.  A capture launches nothing, so the launch counts are
        restored after it; replays bypass the wrappers' counts (a profiler
        trace sees them)."""
        from .. import kernels

        st = self._step
        recent, n_past = st.recent.clone(), self.kv.n_past.clone()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._decode_step()
        torch.cuda.current_stream(self.device).wait_stream(side)
        st.recent.copy_(recent)
        self.kv.n_past.copy_(n_past)
        before = kernels.counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._decode_step()
        kernels.set_counts(before)
        st.graph = graph

    def step(self) -> list[tuple[Slot, int, bool]]:
        """One engine iteration: a prompt chunk for each prefilling slot,
        then one decode step for every generating
        slot.  Returns [(slot, new_token, finished)] for the slots that
        produced a token, first tokens of completed prompts included."""
        results = self._advance_prefill()
        active = []
        for s in self.slots:
            if s.state != SlotState.GENERATING or s.stop_reason is not None:
                continue
            if s.generated and len(s.generated) >= s.n_predict:
                s.stop_reason = "length"
                continue
            active.append(s)
        if not active:
            return results
        if self.ctx_shift:
            for s in active:
                if s.n_past + 1 >= self.max_seq:
                    self._maybe_shift(s)
        t0 = time.perf_counter()
        n = self.n_slots
        tokens = np.zeros((n, 1), np.int64)
        temp = np.zeros(n, np.float32)
        top_k = np.full(n, CAND, np.int32)
        top_p = np.ones(n, np.float32)
        min_p = np.zeros(n, np.float32)
        pen = np.ones(n, np.float32)
        for s in active:
            tokens[s.id, 0] = s.current_token
            temp[s.id] = s.sampler.temp
            top_k[s.id] = self._top_k(s.sampler)
            top_p[s.id] = s.sampler.top_p
            min_p[s.id] = s.sampler.min_p
            pen[s.id] = s.sampler.penalty_repeat
        st = self._step
        on_card = self.device.type == "cuda"
        with torch.inference_mode():
            for buf, arr in ((st.tokens, tokens), (st.temp, temp), (st.top_k, top_k),
                             (st.top_p, top_p), (st.min_p, min_p), (st.penalty, pen),
                             (self.kv.n_past, self.n_past_host)):
                buf.copy_(torch.from_numpy(arr))
            if on_card and st.graph is None:
                self._capture()
            if any(s.sampler.temp > 0 for s in active):
                torch.rand(st.uniforms.shape, generator=self.generator,
                           device=self.device, out=st.uniforms)
                for s in active:  # a seeded request draws from its own generator
                    if s.gen is not None and s.sampler.temp > 0:
                        torch.rand((CAND,), generator=s.gen, device=self.device,
                                   out=st.uniforms[s.id])
            if on_card:
                st.events[0].record()
                st.graph.replay()
                st.events[1].record()
            else:
                self._decode_step()
            new_tokens = st.out.cpu().numpy()
        if on_card:
            self.metrics["t_decode_device_s"] += st.events[0].elapsed_time(st.events[1]) / 1e3
        for s in active:
            tok = int(new_tokens[s.id])
            s.n_past += 1
            self.n_past_host[s.id] = s.n_past
            s.generated.append(tok)
            s.current_token = tok
            results.append((s, tok, self._check_finished(s, tok)))
        self.metrics["t_decode_s"] += time.perf_counter() - t0
        self.metrics["n_decode_steps"] += 1
        self.metrics["n_generated_tokens"] += len(active)
        return results

    def release(self, slot: Slot) -> None:
        """Free a finished slot.  Idle slots still ride every batched step
        and write one dead row at their n_past: it is parked just past the
        cached prefix, so prefix reuse never reads a dead row."""
        slot.reset()
        keep = min(len(slot.cache_tokens), self.max_seq - 1)
        slot.cache_tokens = slot.cache_tokens[:keep]
        self.n_past_host[slot.id] = keep

    def warmup(self) -> None:
        """Run one tiny greedy request to its end before traffic arrives: it
        builds the kernels, decides the decode route and captures the
        decode step.  The metrics are cleared (in a ``finally``, so a
        failed warmup leaves none behind) and the warmup rows are not kept
        for prefix reuse."""
        bos = self.tokenizer.vocab.special.bos or 0
        try:
            slot = self.add_request([int(bos)] * 4, 2, SamplerConfig(temp=0.0),
                                    "warmup")
            if slot is None:  # saturated engine: nothing to warm
                return
            slot.no_cache = True
            for _ in range(8):
                if any(fin for s, _t, fin in self.step() if s is slot):
                    break
            self.release(slot)
        finally:
            for k in self.metrics:
                self.metrics[k] = 0.0 if isinstance(self.metrics[k], float) else 0
