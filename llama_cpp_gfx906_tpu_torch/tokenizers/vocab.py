"""Vocabulary loaded from GGUF metadata (port of
``llama_cpp_gfx906_tpu/tokenizers/vocab.py``).

Holds the token table, scores/types, special-token ids and flags, and the
special-token partition pass: special tokens are cut out of the raw text
first, longest match first; user-defined tokens match even when
``parse_special`` is off, control/unknown only when it is on.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..gguf.constants import Keys, TokenType


@dataclass
class SpecialTokens:
    bos: int | None = None
    eos: int | None = None
    eot: int | None = None
    eom: int | None = None
    unk: int | None = None

    def eog_ids(self) -> set[int]:
        """End-of-generation ids (eos/eot/eom), for stop checks."""
        return {t for t in (self.eos, self.eot, self.eom) if t is not None}


@dataclass
class Vocab:
    model: str  # "llama" (SPM) is the one family this slice tokenizes
    pre: str  # pretokenizer name, kept from the metadata
    tokens: list[str]
    scores: np.ndarray | None
    token_types: np.ndarray | None
    special: SpecialTokens = field(default_factory=SpecialTokens)
    add_bos: bool = False
    add_eos: bool = False
    add_space_prefix: bool = True

    token_to_id: dict[str, int] = field(default_factory=dict, repr=False)
    _special_sorted: list[int] = field(default_factory=list, repr=False)

    def __post_init__(self):
        if not self.token_to_id:
            self.token_to_id = {t: i for i, t in enumerate(self.tokens)}
        self._special_sorted = sorted(
            (
                i
                for i in range(len(self.tokens))
                if self.token_type(i)
                in (TokenType.CONTROL, TokenType.USER_DEFINED, TokenType.UNKNOWN)
                and self.tokens[i]
            ),
            key=lambda i: -len(self.tokens[i]),
        )

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    def token_type(self, idx: int) -> TokenType:
        if self.token_types is None:
            return TokenType.NORMAL
        return TokenType(int(self.token_types[idx]))

    def is_special(self, idx: int) -> bool:
        return self.token_type(idx) in (TokenType.CONTROL, TokenType.UNKNOWN)

    def is_eog(self, idx: int) -> bool:
        return idx in self.special.eog_ids()

    def byte_token(self, byte: int) -> int | None:
        """Id of the byte-fallback token for ``byte`` (SPM ``<0xAB>`` style)."""
        tok = self.token_to_id.get(f"<0x{byte:02X}>")
        if tok is not None:
            return tok
        return self.special.unk

    # -- special-token partition -------------------------------------------

    def partition_specials(
        self, text: str, parse_special: bool
    ) -> list[str | int]:
        """Split ``text`` into raw-text fragments and special-token ids."""
        fragments: list[str | int] = [text] if text else []
        for sid in self._special_sorted:
            ttype = self.token_type(sid)
            if not parse_special and ttype in (TokenType.CONTROL, TokenType.UNKNOWN):
                continue
            stext = self.tokens[sid]
            out: list[str | int] = []
            for frag in fragments:
                if isinstance(frag, int):
                    out.append(frag)
                    continue
                rest = frag
                while True:
                    pos = rest.find(stext)
                    if pos < 0:
                        if rest:
                            out.append(rest)
                        break
                    left, rest = rest[:pos], rest[pos + len(stext) :]
                    if left:
                        out.append(left)
                    out.append(sid)
            fragments = out
        return fragments


def vocab_from_gguf(reader) -> Vocab:
    """Build a :class:`Vocab` from GGUF tokenizer metadata."""
    get = reader.get
    tokens = list(get(Keys.Tokenizer.LIST) or [])
    scores = get(Keys.Tokenizer.SCORES)
    token_types = get(Keys.Tokenizer.TOKEN_TYPE)
    model = str(get(Keys.Tokenizer.MODEL, "llama"))

    def tid(key):
        v = get(key)
        return int(v) if v is not None and int(v) >= 0 else None

    special = SpecialTokens(
        bos=tid(Keys.Tokenizer.BOS_ID),
        eos=tid(Keys.Tokenizer.EOS_ID),
        eot=tid(Keys.Tokenizer.EOT_ID),
        eom=tid(Keys.Tokenizer.EOM_ID),
        unk=tid(Keys.Tokenizer.UNK_ID),
    )

    add_bos = get(Keys.Tokenizer.ADD_BOS)
    add_eos = get(Keys.Tokenizer.ADD_EOS)
    add_space_prefix = get(Keys.Tokenizer.ADD_PREFIX)
    if add_bos is None:
        add_bos = model == "llama"  # SPM defaults to add_bos (llama.cpp behavior)
    if add_eos is None:
        add_eos = False
    if add_space_prefix is None:
        add_space_prefix = model == "llama"

    return Vocab(
        model=model,
        pre=str(get(Keys.Tokenizer.PRE, "default")),
        tokens=tokens,
        scores=np.asarray(scores, np.float32) if scores is not None else None,
        token_types=np.asarray(token_types, np.int32) if token_types is not None else None,
        special=special,
        add_bos=bool(add_bos),
        add_eos=bool(add_eos),
        add_space_prefix=bool(add_space_prefix),
    )
