"""SentencePiece-style tokenizer (port of
``llama_cpp_gfx906_tpu/tokenizers/spm.py``).

Symbols start as UTF-8 codepoints; adjacent pairs merge greedily by highest
vocab score; unmatched pieces resegment recursively and finally fall back to
``<0xAB>`` byte tokens.  Whitespace is escaped to U+2581 and a leading space
is prefixed after BOS/specials.
"""

from __future__ import annotations

import heapq

from .vocab import Vocab

_SPACE = "▁"  # ▁


class SPMTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab

    # -- one escaped fragment ----------------------------------------------

    def encode_fragment(self, text: str) -> list[int]:
        v = self.vocab
        t2i = v.token_to_id
        scores = v.scores
        if not text:
            return []

        symbols: list[str | None] = list(text)  # None = merged away
        prev = list(range(-1, len(symbols) - 1))  # linked list indices
        nxt = list(range(1, len(symbols) + 1))

        rev_merge: dict[str, tuple[str, str]] = {}
        heap: list[tuple[float, int, str]] = []  # (-score, left_idx, merged)

        def try_add(i: int, j: int):
            if i < 0 or j >= len(symbols):
                return
            merged = symbols[i] + symbols[j]
            tok = t2i.get(merged)
            if tok is not None and scores is not None:
                heapq.heappush(heap, (-float(scores[tok]), i, merged))

        for i in range(len(symbols) - 1):
            try_add(i, i + 1)

        while heap:
            _, i, merged = heapq.heappop(heap)
            j = nxt[i]
            # stale entry: symbols changed since this bigram was queued
            if symbols[i] is None or j >= len(symbols) or symbols[j] is None:
                continue
            if symbols[i] + symbols[j] != merged:
                continue
            rev_merge[merged] = (symbols[i], symbols[j])
            symbols[i] = merged
            symbols[j] = None
            nxt[i] = nxt[j]
            if nxt[j] < len(symbols):
                prev[nxt[j]] = i
            try_add(prev[i], i)
            try_add(i, nxt[i])

        out: list[int] = []

        def resegment(piece: str):
            tok = t2i.get(piece)
            if tok is not None:
                out.append(tok)
                return
            halves = rev_merge.get(piece)
            if halves is not None:
                resegment(halves[0])
                resegment(halves[1])
                return
            for b in piece.encode("utf-8"):
                bt = v.byte_token(b)
                if bt is not None:
                    out.append(bt)

        i = 0
        while i < len(symbols):
            if symbols[i] is not None:
                resegment(symbols[i])
            i = nxt[i] if nxt[i] > i else i + 1
        return out

    # -- full text ----------------------------------------------------------

    def tokenize(self, text: str, add_special: bool = True, parse_special: bool = True) -> list[int]:
        v = self.vocab
        out: list[int] = []
        prev_special = True  # prefix the very first fragment with a space
        if add_special and v.add_bos and v.special.bos is not None:
            out.append(v.special.bos)
        for frag in v.partition_specials(text, parse_special):
            if isinstance(frag, int):
                out.append(frag)
                prev_special = True
            else:
                if v.add_space_prefix and prev_special:
                    frag = " " + frag
                out.extend(self.encode_fragment(frag.replace(" ", _SPACE)))
                prev_special = False
        if add_special and v.add_eos and v.special.eos is not None:
            out.append(v.special.eos)
        return out

    # -- decoding -----------------------------------------------------------

    def token_bytes(self, token_id: int, special: bool = False) -> bytes:
        v = self.vocab
        from ..gguf.constants import TokenType

        ttype = v.token_type(token_id)
        text = v.tokens[token_id]
        if ttype == TokenType.BYTE:
            return bytes([int(text[3:5], 16)])
        if ttype in (TokenType.CONTROL, TokenType.UNKNOWN):
            return text.encode("utf-8") if special else b""
        return text.replace(_SPACE, " ").encode("utf-8")

    def detokenize(self, ids: list[int], special: bool = False) -> str:
        raw = b"".join(self.token_bytes(i, special) for i in ids)
        text = raw.decode("utf-8", errors="replace")
        # SPM renders a leading space before the first word; strip it back
        if self.vocab.add_space_prefix and text.startswith(" "):
            text = text[1:]
        return text
