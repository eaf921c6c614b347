"""Single-stream inference engine: load -> prefill -> decode loop (port of
``llama_cpp_gfx906_tpu/runtime/engine.py``: ``from_gguf``, ``reset``,
``prefill``, ``decode_one``, ``generate``).

PyTorch runs eagerly, so there are no shape buckets: prefill runs at the
prompt's own length.  The KV cache is updated in place.  The engine runs on
the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..gguf.reader import GGUFModelReader
from ..models.config import ModelConfig, config_from_gguf
from ..models.llama import KVCache, forward
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


@dataclass
class Engine:
    cfg: ModelConfig
    params: torch.nn.Module
    tokenizer: Tokenizer
    device: torch.device
    max_seq: int = 2048
    kv_dtype: torch.dtype = torch.bfloat16
    perf: PerfCounters = field(default_factory=PerfCounters)

    def __post_init__(self):
        self.reset()

    @classmethod
    def from_gguf(cls, path: str, max_seq: int = 2048,
                  dtype: torch.dtype = torch.bfloat16, device=None,
                  keep_quantized: bool = True) -> "Engine":
        """Load a llama GGUF; weights and the KV cache in ``dtype``.
        ``keep_quantized`` keeps supported quant types block-quantized on
        the device (nib4c for the Q4 family, int8 otherwise, folded k-quant
        scales); off, every weight is dequantized to ``dtype``."""
        dev = resolve_device(device)
        t0 = time.perf_counter()
        reader = GGUFModelReader(path)
        cfg = config_from_gguf(reader)
        tok = tokenizer_from_gguf(reader)
        if keep_quantized:
            params = load_llama_params_quantized(reader, cfg, dtype, dev)
        else:
            params = load_llama_params(reader, cfg, dtype, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        eng = cls(cfg=cfg, params=params, tokenizer=tok, device=dev,
                  max_seq=max_seq, kv_dtype=dtype)
        eng.perf.t_load_s = time.perf_counter() - t0
        return eng

    def reset(self) -> None:
        self.kv = KVCache.create(self.cfg, 1, self.max_seq, self.kv_dtype,
                                 self.device)
        self._n_past = 0

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
