"""Language-goal embedding providers (port of
`manigaussian_tpu/data/language.py`).

Each goal string is embedded once, at replay-fill time, into a sentence
embedding [1024] and token embeddings [77, 512] (reference
`helpers/clip/core/clip.py:479`, `launch_utils.py:228`); the tower is frozen.
  * HashedStubLanguageModel — deterministic per-word vectors (the same as
    the JAX package's for the same string), for runs without weights;
  * ClipRN50TextModel — the reference's RN50 text tower
    (`models/clip_text.py`) from an OpenAI `.pt` checkpoint, with the BPE
    tokenizer (`data/clip_tokenizer.py`), on the GPU unless asked for the
    CPU; tiny test checkpoints are zero-padded into the same slots;
  * ClipLanguageModel, T5LanguageModel — a local `transformers` checkpoint
    directory (imported at construction), on the CPU as in JAX;
  * CachedLanguageModel — an on-disk .npz cache keyed by the string.
"""

from __future__ import annotations

import hashlib
import os
from typing import Protocol, Tuple

import numpy as np

from manigaussian_tpu_torch.utils.device import DeviceLike, resolve_device

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


def _pad(sent: np.ndarray, embs: np.ndarray):
    """Zero-pad (or cut) into the [1024] and [77, 512] slots."""
    out_s = np.zeros(SENTENCE_DIM, np.float32)
    out_s[:min(sent.shape[0], SENTENCE_DIM)] = sent[:SENTENCE_DIM]
    out_t = np.zeros((MAX_TOKENS, TOKEN_DIM), np.float32)
    n, d = min(embs.shape[0], MAX_TOKENS), min(embs.shape[1], TOKEN_DIM)
    out_t[:n, :d] = embs[:n, :d]
    return out_s, out_t


class ClipRN50TextModel:
    """The reference's text interface from an OpenAI CLIP checkpoint:
    sentence = ln_final at EOT @ text_projection [1024], tokens = ln_final's
    outputs [77, 512] (clip.py:479 encode_text_with_embeddings), through
    `models/clip_text.ClipTextTransformer` (8 heads) and the BPE tokenizer.
    `checkpoint_path` is a path or a state dict; a `.msgpack` file is the
    flax tower of `tools/convert_weights clip` (either package's)."""

    def __init__(self, checkpoint_path, bpe_path: str | None = None,
                 device: DeviceLike = None):
        import torch

        from manigaussian_tpu_torch.data.clip_tokenizer import \
            ClipBPETokenizer
        from manigaussian_tpu_torch.models import clip_text as ct

        self.device = resolve_device(device)
        self.tokenizer = ClipBPETokenizer(bpe_path)
        if isinstance(checkpoint_path, str) and \
                checkpoint_path.endswith(".msgpack"):
            from manigaussian_tpu_torch.convert import clip_text_state_dict
            from manigaussian_tpu_torch.tools.convert_weights import \
                load_converted
            payload = load_converted(checkpoint_path)
            dims = payload["dims"]
            sd = clip_text_state_dict(payload["variables"])
        else:
            sd = ct.load_openai_state_dict(checkpoint_path)
            dims = ct.model_dims_from_state_dict(sd)
        self.model = ct.ClipTextTransformer(**dims)
        self.model.load_state_dict(sd)
        self.model.to(self.device).eval()

    def encode(self, text: str):
        import torch
        toks = self.tokenizer.tokenize(
            text, context_length=self.model.context_length)[None]
        with torch.no_grad():
            sent, embs = self.model(torch.as_tensor(toks, dtype=torch.long,
                                                    device=self.device))
        return _pad(sent[0].float().cpu().numpy(),
                    embs[0].float().cpu().numpy())


class ClipLanguageModel:
    """CLIP text tower from a local `transformers` checkpoint directory.
    Not the reference's architecture (that is the RN50 tower's 1024-d joint
    space, ClipRN50TextModel); for environments that only have HF-format
    CLIP. The sentence embedding is zero-padded into the 1024-d slot."""

    def __init__(self, checkpoint_dir: str):
        from transformers import CLIPTextModelWithProjection, CLIPTokenizerFast
        self.tokenizer = CLIPTokenizerFast.from_pretrained(checkpoint_dir)
        self.model = CLIPTextModelWithProjection.from_pretrained(checkpoint_dir)
        self.model.eval()

    def encode(self, text: str):
        import torch
        with torch.no_grad():
            toks = self.tokenizer(text, padding="max_length",
                                  max_length=MAX_TOKENS, truncation=True,
                                  return_tensors="pt")
            out = self.model(**toks, output_hidden_states=True)
            token_embs = out.last_hidden_state[0].float().numpy()
            sent = out.text_embeds[0].float().numpy()
        if sent.shape[0] < SENTENCE_DIM:
            sent = np.concatenate(
                [sent, np.zeros(SENTENCE_DIM - sent.shape[0], np.float32)])
        return sent.astype(np.float32), token_embs.astype(np.float32)


class T5LanguageModel:
    """T5 encoder from a local checkpoint directory, the reference's
    semantics (helpers/language_model.py:14-32): the sentence embedding is
    zeros [1024] and the token embeddings are T5's raw last_hidden_state
    padded to 77 tokens, no projection (set method.language_model_dim to the
    checkpoint's d_model)."""

    def __init__(self, checkpoint_dir: str):
        from transformers import T5EncoderModel, T5TokenizerFast
        self.tokenizer = T5TokenizerFast.from_pretrained(checkpoint_dir)
        self.model = T5EncoderModel.from_pretrained(checkpoint_dir).eval()

    def encode(self, text: str):
        import torch
        with torch.no_grad():
            toks = self.tokenizer(text, padding="max_length",
                                  max_length=MAX_TOKENS, truncation=True,
                                  return_tensors="pt")
            hidden = self.model(**toks).last_hidden_state[0].float().numpy()
        if hidden.shape[0] < MAX_TOKENS:
            hidden = np.concatenate(
                [hidden, np.zeros((MAX_TOKENS - hidden.shape[0],
                                   hidden.shape[1]), np.float32)], axis=0)
        sent = np.zeros(SENTENCE_DIM, np.float32)
        return sent, hidden[:MAX_TOKENS].astype(np.float32)


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
            # written whole or not at all: the eval workers of one log dir
            # share this cache, and one may read while another writes
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                np.savez(f, sent=out[0], toks=out[1])
            os.replace(tmp, path)
        self._mem[text] = out
        return out


def create_language_model(name: str = "stub",
                          checkpoint_dir: str | None = None,
                          cache_dir: str | None = None,
                          device: DeviceLike = None) -> LanguageModel:
    """Factory (parity: helpers/language_model.py:15-33
    create_language_model), JAX's routes: CLIP with a file → the RN50 tower
    (on `device`, the GPU by default); CLIP with a directory → transformers'
    CLIP; T5 with a directory → transformers' T5; anything without a
    checkpoint → the hashed stub."""
    if name in ("CLIP", "clip") and checkpoint_dir:
        if os.path.isfile(checkpoint_dir):
            model: LanguageModel = ClipRN50TextModel(checkpoint_dir,
                                                     device=device)
        else:
            model = ClipLanguageModel(checkpoint_dir)
    elif name in ("T5", "t5") and checkpoint_dir:
        model = T5LanguageModel(checkpoint_dir)
    else:
        model = HashedStubLanguageModel()
    if cache_dir:
        model = CachedLanguageModel(model, cache_dir)
    return model
