"""The port's `convert_weights t5` against the JAX tool's `convert_t5`
(transformers' `FlaxT5EncoderModel.from_pretrained(from_pt=True)` then
`save_pretrained`) on tiny seeded T5 models built offline, with a vocab
made by `tokenizers`: `flax_model.msgpack` equal byte for byte, and
`config.json` equal as a dict apart from `transformers_version`; from
`pytorch_model.bin` and from `model.safetensors`, for an encoder and for a
whole encoder-decoder checkpoint (its decoder and head left out).
"""

import json
import os

import pytest
import torch

from manigaussian_tpu.tools.convert_weights import convert_t5 as j_convert
from manigaussian_tpu_torch.models.dinov2 import read_hf_weights
from manigaussian_tpu_torch.tools import convert_weights as TW

TASK_WORDS = "open drawer turn tap push the buttons close jar".split()


def tiny_t5_dir(path: str, full: bool = False, safetensors: bool = False,
                seed: int = 0) -> str:
    """A Hugging Face T5 directory: a Unigram tokenizer over a few words
    and letters, and a 2-layer T5 (T5EncoderModel, or with `full` a
    T5ForConditionalGeneration) from `seed`."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, \
        processors
    from transformers import (T5Config, T5EncoderModel,
                              T5ForConditionalGeneration, T5TokenizerFast)
    vocab = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)]
    vocab += [(f"▁{w}", -float(i)) for i, w in enumerate(TASK_WORDS)]
    vocab += [(c, -20.0) for c in "abcdefghijklmnopqrstuvwxyz"]
    tok = Tokenizer(models.Unigram(vocab, unk_id=2))
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.decoder = decoders.Metaspace()
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", special_tokens=[("</s>", 1)])
    T5TokenizerFast(tokenizer_object=tok, eos_token="</s>", unk_token="<unk>",
                    pad_token="<pad>", extra_ids=0).save_pretrained(path)
    torch.manual_seed(seed)
    cfg = T5Config(vocab_size=len(vocab), d_model=16, d_kv=4, d_ff=32,
                   num_layers=2, num_decoder_layers=1, num_heads=2,
                   relative_attention_num_buckets=8,
                   relative_attention_max_distance=16,
                   decoder_start_token_id=0,
                   feed_forward_proj="gated-gelu" if full else "relu")
    model = (T5ForConditionalGeneration if full else T5EncoderModel)(cfg)
    model.save_pretrained(path, safe_serialization=safetensors)
    return path


@pytest.mark.parametrize("full,safetensors", [(False, False), (False, True),
                                              (True, True)])
def test_t5_directory_equals_jax(tmp_path, full, safetensors):
    src = tiny_t5_dir(str(tmp_path / "in"), full, safetensors)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    j_convert(src, jdir)
    TW.main(["t5", src, tdir])
    with open(os.path.join(jdir, "flax_model.msgpack"), "rb") as f:
        want = f.read()
    with open(os.path.join(tdir, "flax_model.msgpack"), "rb") as f:
        assert f.read() == want
    cfgs = []
    for d in (jdir, tdir):
        with open(os.path.join(d, "config.json")) as f:
            c = json.load(f)
        c.pop("transformers_version")
        cfgs.append(c)
    assert cfgs[1] == cfgs[0]
    assert cfgs[1]["architectures"] == ["T5EncoderModel"]
    for name in ("tokenizer.json", "tokenizer_config.json"):
        with open(os.path.join(src, name), "rb") as a, \
                open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read()
    # the port's codec reads its own file back to the torch weights
    tree = TW.msgpack_restore(want)
    sd = read_hf_weights(src)
    assert (tree["shared"]["embedding"] == sd["shared.weight"].numpy()).all()
    q = tree["encoder"]["block"]["0"]["layer"]["0"]["SelfAttention"]["q"]
    assert (q["kernel"] == sd[
        "encoder.block.0.layer.0.SelfAttention.q.weight"].numpy().T).all()
