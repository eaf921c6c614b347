"""Tokenizers loaded from GGUF vocab metadata: the SPM family
(``tokenizer.ggml.model == "llama"``) in this slice."""

from __future__ import annotations

from .spm import SPMTokenizer
from .vocab import SpecialTokens, Vocab, vocab_from_gguf

Tokenizer = SPMTokenizer


def tokenizer_from_gguf(reader) -> SPMTokenizer:
    vocab = vocab_from_gguf(reader)
    if vocab.model != "llama":
        raise NotImplementedError(f"tokenizer model {vocab.model!r} is not ported yet")
    return SPMTokenizer(vocab)


__all__ = ["SPMTokenizer", "SpecialTokens", "Tokenizer", "Vocab",
           "tokenizer_from_gguf", "vocab_from_gguf"]
