"""Greedy text generation from a GGUF model.

Usage:
    python -m llama_cpp_gfx906_tpu_torch.tools.cli -m model.gguf -p "prompt" -n 32 \
        [--device cuda|cpu] [-gan 4 -gaw 1024]

``-gan``/``--grp-attn-n`` > 1 turns on self-extend (grouped attention,
JAX ``tools/cli.py`` ``_generate_self_extend``): whenever the next logical
position passes ``ga_i + ga_w`` the cache's positions are compressed by
``ga_n`` through ``Engine.seq_add`` / ``seq_div`` / ``seq_add``, so the
context can run past the trained length.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..runtime.engine import Engine
from ..sampling.samplers import SamplerChain, SamplerParams


def ladder(n_p: int, ga_i: int, ga_n: int, ga_w: int) -> tuple[list, int, int]:
    """The cache calls of llama.cpp main's self-extend before the token at
    logical position ``n_p`` (JAX ``_generate_self_extend``): while ``n_p``
    reaches ``ga_i + ga_w``, seq_add / seq_div / seq_add of the next block.
    Returns ([(method name, args)], the new n_p, the new ga_i)."""
    calls = []
    while n_p >= ga_i + ga_w:
        ib = (ga_n * ga_i) // ga_w
        bd = (ga_w // ga_n) * (ga_n - 1)
        dd = (ga_w // ga_n) - ib * bd - ga_w
        calls += [("seq_add", (ga_i, n_p, ib * bd)),
                  ("seq_div", (ga_i + ib * bd, n_p + ib * bd, ga_n)),
                  ("seq_add", (ga_i + ib * bd + ga_w, n_p + ib * bd, dd))]
        n_p -= bd
        ga_i += ga_w // ga_n
    return calls, n_p, ga_i


def _generate_self_extend(eng: Engine, ids: list[int], n_predict: int, ga_n: int,
                          ga_w: int, stop_on_eog: bool = True) -> list[int]:
    """Greedy generation from the prompt ``ids`` with self-extend: the
    ladder (:func:`ladder`) before each token, then ``decode_one``.
    Returns the new token ids (stopping at an end-of-generation token
    unless ``stop_on_eog`` is off, as ``Engine.generate``)."""
    eng.reset()
    chain = SamplerChain(SamplerParams(greedy=True), eng.cfg.n_vocab)
    logits = eng.prefill(ids)
    n_p, ga_i = len(ids), 0  # the next token's logical position
    eog = eng.tokenizer.vocab.special.eog_ids()
    all_ids, out = list(ids), []
    for _ in range(n_predict):
        calls, n_p, ga_i = ladder(n_p, ga_i, ga_n, ga_w)
        for name, args in calls:
            getattr(eng, name)(*args)
        tok = chain.sample(logits, all_ids)
        chain.accept(tok, is_eog=tok in eog)
        if stop_on_eog and tok in eog:
            break
        all_ids.append(tok)
        out.append(tok)
        logits = eng.decode_one(tok)
        n_p += 1
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="greedy generation (PyTorch/CUDA port)")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-p", "--prompt", default="")
    ap.add_argument("-n", "--n-predict", type=int, default=32)
    ap.add_argument("-c", "--ctx-size", type=int, default=2048)
    ap.add_argument("-gan", "--grp-attn-n", type=int, default=1,
                    help="self-extend group factor (1: off)")
    ap.add_argument("-gaw", "--grp-attn-w", type=int, default=512,
                    help="self-extend group width")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    eng = Engine.from_gguf(args.model, max_seq=args.ctx_size, device=args.device,
                           dtype=torch.bfloat16)
    if args.grp_attn_n > 1:
        ids = eng.tokenizer.tokenize(args.prompt, add_special=True, parse_special=True)
        text = eng.tokenizer.detokenize(_generate_self_extend(
            eng, ids, args.n_predict, args.grp_attn_n, args.grp_attn_w))
    else:
        text, _ = eng.generate(args.prompt, n_predict=args.n_predict)
    sys.stdout.write(args.prompt + text + "\n")
    print(json.dumps(eng.perf.summary()), file=sys.stderr)


if __name__ == "__main__":
    main()
