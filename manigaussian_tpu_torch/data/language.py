"""Language-goal embedding providers (host side).

A copy of the jax-free part of `manigaussian_tpu/data/language.py`: the
hashed stub provider and the on-disk cache, with the same vectors for the
same string. The CLIP and T5 towers are not ported yet; asking for one by
checkpoint raises.
"""

from __future__ import annotations

import hashlib
import os
from typing import Protocol, Tuple

import numpy as np

SENTENCE_DIM = 1024
TOKEN_DIM = 512
MAX_TOKENS = 77


class LanguageModel(Protocol):
    def encode(self, text: str) -> Tuple[np.ndarray, np.ndarray]:
        """text → (sentence_emb [1024], token_embs [77, 512])."""
        ...


class HashedStubLanguageModel:
    """Deterministic per-word gaussian embeddings (seeded by word hash)."""

    def __init__(self, sentence_dim: int = SENTENCE_DIM,
                 token_dim: int = TOKEN_DIM, max_tokens: int = MAX_TOKENS):
        self.sentence_dim = sentence_dim
        self.token_dim = token_dim
        self.max_tokens = max_tokens

    def _vec(self, word: str, dim: int) -> np.ndarray:
        seed = int.from_bytes(
            hashlib.sha256(word.encode()).digest()[:4], "little")
        return np.random.default_rng(seed).standard_normal(dim).astype(np.float32)

    def encode(self, text: str):
        words = text.lower().split()[: self.max_tokens - 2]
        toks = np.zeros((self.max_tokens, self.token_dim), np.float32)
        toks[0] = self._vec("<sot>", self.token_dim)
        for i, w in enumerate(words):
            toks[i + 1] = self._vec(w, self.token_dim)
        toks[len(words) + 1] = self._vec("<eot>", self.token_dim)
        sent = self._vec("sent::" + text.lower(), self.sentence_dim)
        return sent, toks


class CachedLanguageModel:
    """On-disk cache: <cache_dir>/<sha1(text)>.npz."""

    def __init__(self, base: LanguageModel, cache_dir: str):
        self.base = base
        self.cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)
        self._mem = {}

    def encode(self, text: str):
        if text in self._mem:
            return self._mem[text]
        key = hashlib.sha1(text.encode()).hexdigest()
        path = os.path.join(self.cache_dir, key + ".npz")
        if os.path.exists(path):
            z = np.load(path)
            out = (z["sent"], z["toks"])
        else:
            out = self.base.encode(text)
            np.savez(path, sent=out[0], toks=out[1])
        self._mem[text] = out
        return out


def create_language_model(name: str = "stub",
                          checkpoint_dir: str | None = None,
                          cache_dir: str | None = None) -> LanguageModel:
    """Factory (parity: helpers/language_model.py:15-33 create_language_model).
    Without a checkpoint every name maps to the hashed stub, as in the JAX
    package."""
    if checkpoint_dir:
        raise NotImplementedError(
            f"the {name} text tower is not ported yet; run without a "
            "language-model checkpoint to use the hashed stub")
    model: LanguageModel = HashedStubLanguageModel()
    if cache_dir:
        model = CachedLanguageModel(model, cache_dir)
    return model
