"""The port's language towers (`manigaussian_tpu_torch/models/clip_text.py`,
`data/clip_tokenizer.py`, `data/language.py`) against the JAX package and
the torch twin of tests/test_clip_text.py, on the CPU.

No CLIP checkpoint or BPE vocab is in the repository: the RN50 text tower
is checked from random weights, on token ids, against the flax tower (the
same OpenAI state dict through each package's loader) and against
`_TorchTextTwin` (OpenAI's block layout on nn.MultiheadAttention), within
1e-4 relative; the tokenizer and the `.pt` route of `create_language_model`
are checked against JAX's on a generated merge list of the real size (a
stand-in vocab: its ids are not CLIP's); the tests that need the real vocab
skip without it, as the JAX ones do. The transformers CLIP and T5 providers
run tiny in-memory models with a stub tokenizer, as
tests/test_data_pipeline.py does for T5.
"""

import gzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manigaussian_tpu.data import clip_tokenizer as JT
from manigaussian_tpu.data import language as JL
from manigaussian_tpu.models import clip_text as JC
from manigaussian_tpu_torch.data import clip_tokenizer as TT
from manigaussian_tpu_torch.data import language as TL
from manigaussian_tpu_torch.models import clip_text as TC
from tests.test_clip_text import (CTX, EMBED, HEADS, LAYERS, VOCAB, WIDTH,
                                  _TorchTextTwin)

TOL = 1e-4


def twin_tokens(seed=1, b=3):
    rng = np.random.default_rng(seed)
    toks = np.zeros((b, CTX), np.int64)
    for i in range(b):
        n = rng.integers(3, CTX - 1)
        toks[i, 0] = 1
        toks[i, 1:n] = rng.integers(2, VOCAB - 1, n - 1)
        toks[i, n] = VOCAB - 1          # eot = the highest id (argmax)
    return toks


def close(actual, expected, tol=TOL, err_msg=""):
    a = np.asarray(actual, np.float32)
    e = np.asarray(expected, np.float32)
    np.testing.assert_allclose(a, e, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(e).max())),
                               err_msg=err_msg)


@pytest.fixture(scope="module")
def twin():
    torch.manual_seed(0)
    t = _TorchTextTwin().eval()
    sd = t.clip_state_dict()
    model = TC.ClipTextTransformer(**TC.model_dims_from_state_dict(sd),
                                   heads=HEADS)
    model.load_state_dict(TC.load_openai_state_dict(sd))
    return t, sd, model.eval()


def test_dims_from_the_state_dict_match_jax(twin):
    _, sd, _ = twin
    assert TC.model_dims_from_state_dict(sd) == JC.model_dims_from_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    assert TC.model_dims_from_state_dict(sd) == dict(
        vocab_size=VOCAB, context_length=CTX, width=WIDTH, layers=LAYERS,
        embed_dim=EMBED)


@pytest.mark.parametrize("against", ["flax", "torch_twin"])
def test_tower_matches(twin, against):
    t, sd, model = twin
    toks = twin_tokens()
    with torch.no_grad():
        sent, emb = model(torch.from_numpy(toks))
    if against == "flax":
        jm = JC.ClipTextTransformer(vocab_size=VOCAB, context_length=CTX,
                                    width=WIDTH, heads=HEADS, layers=LAYERS,
                                    embed_dim=EMBED)
        want_s, want_e = jm.apply(JC.load_openai_state_dict(sd),
                                  jnp.asarray(toks, jnp.int32))
    else:
        with torch.no_grad():
            want_s, want_e = t.encode_text_with_embeddings(torch.from_numpy(toks))
    close(emb, want_e, err_msg="token embeddings")
    close(sent, want_s, err_msg="sentence embedding")


def test_loader_reads_a_saved_checkpoint_and_drops_the_visual_tower(
        twin, tmp_path):
    _, sd, model = twin
    full = dict(sd, **{"visual.conv1.weight": torch.zeros(2, 3, 1, 1),
                       "logit_scale": torch.ones(())})
    path = tmp_path / "clip.pt"
    torch.save(full, str(path))
    loaded = TC.load_openai_state_dict(str(path))
    assert set(loaded) == set(sd)
    for k, v in sd.items():
        assert torch.equal(loaded[k], v.float())
    assert set(loaded) == set(model.state_dict())


def test_the_published_width_runs():
    """RN50's text tower (width 512, 12 layers, 8 heads, context 77, vocab
    49408, embed 1024) from seeded random weights: shapes and finite."""
    model = TC.ClipTextTransformer().init_params(
        torch.Generator().manual_seed(0)).eval()
    n = sum(p.numel() for p in model.parameters())
    assert n == (49408 * 512 + 77 * 512 + 512 * 1024 + 2 * 512
                 + 12 * (4 * 512 + 3 * 512 * 512 + 3 * 512 + 512 * 512 + 512
                         + 512 * 2048 + 2048 + 2048 * 512 + 512))
    toks = torch.zeros(2, 77, dtype=torch.long)
    toks[:, 0], toks[0, 1:4], toks[0, 4], toks[1, 1] = 49406, 320, 49407, 49407
    with torch.no_grad():
        sent, emb = model(toks)
    assert sent.shape == (2, 1024) and emb.shape == (2, 77, 512)
    assert torch.isfinite(sent).all() and torch.isfinite(emb).all()


# ------------------------------------------------------------- tokenizer
def stand_in_vocab(path):
    """A merge list of CLIP's size (48,894 merges after a header line): a
    few real-looking merges, then unique ones that never apply."""
    merges = ["o p", "op e", "ope n</w>", "t h", "th e</w>", "d r", "dr a",
              "dra w", "draw e", "drawe r</w>", "t o", "to p</w>", "b l",
              "bl o", "blo c", "bloc k</w>"]
    merges += [f"q{i} z{i}" for i in range(49152 - 256 - 2 - len(merges))]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    return stand_in_vocab(tmp_path_factory.mktemp("bpe") / "bpe.txt.gz")


TEXTS = ["open the top drawer", "Put the BLOCK on   the drawer!",
         "stack 2 blocks &amp; close it", " ".join(["block"] * 200)]


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizer_matches_jax_on_a_stand_in_vocab(vocab, text):
    ours, theirs = TT.ClipBPETokenizer(vocab), JT.ClipBPETokenizer(vocab)
    assert ours.encode(text) == theirs.encode(text)
    ids = ours.tokenize(text)
    np.testing.assert_array_equal(ids, theirs.tokenize(text))
    assert ids.shape == (77,) and ids[0] == ours.sot
    assert ours.eot in ids
    assert ours.decode(ours.encode(text)).strip() == \
        theirs.decode(theirs.encode(text)).strip()


def test_tokenizer_without_a_vocab_raises(monkeypatch):
    monkeypatch.setattr(TT, "_DEFAULT_PATHS", ("",))
    assert TT.find_bpe_vocab() is None
    with pytest.raises(FileNotFoundError, match="BPE vocab"):
        TT.ClipBPETokenizer()


def test_tokenizer_known_clip_ids():
    if TT.find_bpe_vocab() is None:
        pytest.skip("no BPE vocab file available")
    t = TT.ClipBPETokenizer()
    ids = t.tokenize("a photo of a cat")
    np.testing.assert_array_equal(
        ids[:7], [49406, 320, 1125, 539, 320, 2368, 49407])
    assert (ids[7:] == 0).all()
    assert t.decode(t.encode("open the top drawer")).strip() \
        == "open the top drawer"


# ----------------------------------------------------------- providers
def test_pt_route_matches_jax(twin, vocab, tmp_path, monkeypatch):
    """create_language_model("CLIP", <file.pt>) → the RN50 tower, the
    tokenizer and the zero-padding into the [1024] / [77, 512] slots. The
    twin's embedding table is widened to CLIP's 49,408 ids, which the
    tokenizer emits (JAX clamps an id past the table; the port raises)."""
    _, sd, _ = twin
    sd = dict(sd, **{"token_embedding.weight": torch.randn(
        49408, WIDTH, generator=torch.Generator().manual_seed(2))})
    ckpt = tmp_path / "tiny_clip.pt"
    torch.save(sd, str(ckpt))
    monkeypatch.setattr(TT, "_DEFAULT_PATHS", (vocab,))
    monkeypatch.setattr(JT, "_DEFAULT_PATHS", (vocab,))
    ours = TL.create_language_model("CLIP", checkpoint_dir=str(ckpt),
                                    device="cpu")
    theirs = JL.create_language_model("CLIP", checkpoint_dir=str(ckpt))
    assert isinstance(ours, TL.ClipRN50TextModel)
    assert ours.model.context_length == CTX
    for text in ("open the drawer", "stack the blocks"):
        sent, toks = ours.encode(text)
        want_s, want_t = theirs.encode(text)
        assert sent.shape == (1024,) and toks.shape == (77, 512)
        assert not sent[EMBED:].any() and not toks[:, WIDTH:].any()
        assert not toks[CTX:].any()
        # JAX's tower has 8 heads whatever the width (ClipTextTransformer's
        # default), as the port's provider
        close(sent, want_s, err_msg="sentence")
        close(toks, want_t, err_msg="tokens")


def test_rn50_provider_runs_on_the_card_unless_asked(twin, vocab, tmp_path,
                                                     monkeypatch):
    _, sd, _ = twin
    ckpt = tmp_path / "tiny_clip.pt"
    torch.save(sd, str(ckpt))
    monkeypatch.setattr(TT, "_DEFAULT_PATHS", (vocab,))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TL.create_language_model("CLIP", checkpoint_dir=str(ckpt))
    # the port's converted .msgpack loads the same tower
    from manigaussian_tpu_torch.tools.convert_weights import convert_clip
    convert_clip(str(ckpt), str(tmp_path / "clip.msgpack"))
    direct = TL.ClipRN50TextModel(str(ckpt), device="cpu").model
    converted = TL.ClipRN50TextModel(str(tmp_path / "clip.msgpack"),
                                     device="cpu").model
    for (k, a), b in zip(direct.state_dict().items(),
                         converted.state_dict().values()):
        assert torch.equal(a, b), k


def test_factory_routes(tmp_path, monkeypatch):
    seen = []
    for cls in (TL.ClipRN50TextModel, TL.ClipLanguageModel,
                TL.T5LanguageModel):
        monkeypatch.setattr(cls, "__init__", lambda self, path, *a, _c=cls,
                            **k: seen.append((_c.__name__, path)))
    f = tmp_path / "rn50.pt"
    f.write_bytes(b"")
    d = str(tmp_path)
    assert isinstance(TL.create_language_model("CLIP", str(f)),
                      TL.ClipRN50TextModel)
    assert isinstance(TL.create_language_model("clip", d), TL.ClipLanguageModel)
    assert isinstance(TL.create_language_model("T5", d), TL.T5LanguageModel)
    assert isinstance(TL.create_language_model("CLIP"),
                      TL.HashedStubLanguageModel)
    assert isinstance(TL.create_language_model("T5", None, cache_dir=d + "/c"),
                      TL.CachedLanguageModel)
    assert seen == [("ClipRN50TextModel", str(f)), ("ClipLanguageModel", d),
                    ("T5LanguageModel", d)]


class StubTok:
    """Word ids from a fixed table, padded to max_length."""

    def __call__(self, text, padding=None, max_length=None, truncation=None,
                 return_tensors=None):
        table = {"open": 5, "the": 6, "drawer": 7, "stack": 8}
        ids = [table.get(w, 3) for w in text.split()][:max_length]
        ids = ids + [0] * (max_length - len(ids))
        return {"input_ids": torch.tensor([ids]),
                "attention_mask": torch.tensor([[1 if i else 0 for i in ids]])}


def _provider(cls, model):
    lm = cls.__new__(cls)
    lm.tokenizer, lm.model = StubTok(), model
    return lm


def test_transformers_clip_provider_matches_jax():
    from transformers import CLIPTextConfig, CLIPTextModelWithProjection
    torch.manual_seed(0)
    config = CLIPTextConfig(vocab_size=64, hidden_size=16,
                            intermediate_size=32, num_hidden_layers=2,
                            num_attention_heads=2, max_position_embeddings=77,
                            projection_dim=24)
    model = CLIPTextModelWithProjection(config).eval()
    sent, toks = _provider(TL.ClipLanguageModel, model).encode("open the drawer")
    want_s, want_t = _provider(JL.ClipLanguageModel, model).encode(
        "open the drawer")
    assert sent.shape == (1024,) and not sent[24:].any()
    assert toks.shape == (77, 16)
    np.testing.assert_array_equal(sent, want_s)
    np.testing.assert_array_equal(toks, want_t)


def test_transformers_t5_provider_matches_jax():
    from transformers import T5Config, T5EncoderModel
    torch.manual_seed(0)
    config = T5Config(vocab_size=64, d_model=16, d_kv=4, d_ff=32,
                      num_layers=2, num_heads=2)
    model = T5EncoderModel(config).eval()
    sent, toks = _provider(TL.T5LanguageModel, model).encode("open the drawer")
    want_s, want_t = _provider(JL.T5LanguageModel, model).encode(
        "open the drawer")
    assert sent.shape == (1024,) and not sent.any()
    assert toks.shape == (77, 16)
    np.testing.assert_array_equal(toks, want_t)
    np.testing.assert_array_equal(sent, want_s)
