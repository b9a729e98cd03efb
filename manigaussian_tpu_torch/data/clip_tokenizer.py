"""CLIP byte-pair-encoding tokenizer (a copy of
`manigaussian_tpu/data/clip_tokenizer.py`, an independent implementation).

Parity target: the reference vendors OpenAI CLIP's SimpleTokenizer
(`helpers/clip/core/simple_tokenizer.py`) and tokenizes goal strings with
`clip.tokenize` (context length 77, <|startoftext|> ... <|endoftext|>,
`helpers/clip/core/clip.py:558-589`). This is an independent implementation of
the published BPE scheme: lowercased text is split by a word pattern, each word
is mapped through the bytes→unicode table, greedily merged by rank using the
merge list from `bpe_simple_vocab_16e6.txt.gz`, and the final word token gets a
'</w>' suffix.

The merge-vocab file is DATA, not code; its path is configurable
(`CLIP_BPE_PATH` env var or ctor arg). The known locations are probed: the
variable, `assets/` at the root of this repository and the user's CLIP cache
(the JAX package also probes a checkout of the original repository, which is
not part of this one). Without a vocab file the tokenizer cannot be
constructed — callers fall back to the hashed stub provider
(data/language.py).
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
from typing import List

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_DEFAULT_PATHS = (
    os.environ.get("CLIP_BPE_PATH", ""),
    os.path.join(_REPO_ROOT, "assets", "bpe_simple_vocab_16e6.txt.gz"),
    os.path.expanduser("~/.cache/clip/bpe_simple_vocab_16e6.txt.gz"),
)


def find_bpe_vocab() -> str | None:
    for p in _DEFAULT_PATHS:
        if p and os.path.exists(p):
            return p
    return None


@functools.lru_cache(maxsize=1)
def _bytes_to_unicode():
    """Reversible bytes→printable-unicode map (GPT-2/CLIP scheme): printable
    latin bytes map to themselves, the rest to 256+offset codepoints."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


# python re has no \p classes (the upstream uses the `regex` module); these
# ASCII+latin classes cover RLBench goal strings exactly.
_WORD_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[a-zA-ZÀ-ɏ]+|[0-9]|[^\sa-zA-Z0-9À-ɏ]+",
    re.IGNORECASE)


class ClipBPETokenizer:
    """encode(text) -> list[int]; tokenize(text) -> padded [77] int array."""

    def __init__(self, bpe_path: str | None = None):
        bpe_path = bpe_path or find_bpe_vocab()
        if bpe_path is None:
            raise FileNotFoundError(
                "CLIP BPE vocab not found; set CLIP_BPE_PATH or place "
                "bpe_simple_vocab_16e6.txt.gz in one of: "
                + ", ".join(p for p in _DEFAULT_PATHS if p))
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merge_lines = f.read().split("\n")
        # line 0 is a version header; the CLIP vocab uses the first
        # 49152-256-2 merges
        merges = [tuple(m.split()) for m in
                  merge_lines[1: 49152 - 256 - 2 + 1]]
        vocab = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        assert len(vocab) == VOCAB_SIZE, len(vocab)
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self._cache = {"<|startoftext|>": "<|startoftext|>",
                       "<|endoftext|>": "<|endoftext|>"}

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = html.unescape(html.unescape(text.strip()))
        text = re.sub(r"\s+", " ", text).lower()
        ids: List[int] = []
        for tok in _WORD_PAT.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text
                        if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def tokenize(self, text: str, context_length: int = CONTEXT_LENGTH):
        """[context_length] int32, <sot> ids <eot> zero-padded; truncates long
        text keeping the final <eot> (clip.py:558-589 truncate=True)."""
        import numpy as np

        ids = [self.sot] + self.encode(text) + [self.eot]
        if len(ids) > context_length:
            ids = ids[: context_length - 1] + [self.eot]
        out = np.zeros((context_length,), np.int32)
        out[: len(ids)] = ids
        return out
