"""The port's `tools/convert_weights.py` (flax's `.msgpack` in pure Python)
and the three towers' `.msgpack` route, against the JAX package's
`tools/convert_weights.py`, on the tiny torch twins of
tests/test_{clip_text,dinov2,sd_vae}.py.

Both ways, for CLIP text, DINOv2 and the SD VAE: the JAX tool's file loads
in the port, and the port's tower from it gives the outputs of the port's
tower from the torch checkpoint bit for bit; the port's tool writes the
JAX tool's bytes, which JAX's `load_converted` reads as the same tree. The
inverse maps of `convert.py` round-trip a state dict bit for bit. The codec
against flax and `msgpack` on the other types flax writes (numpy scalars,
complex, bfloat16, chunked arrays), and in a process where `msgpack`,
`flax` and `jax` cannot be imported.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from flax import serialization as fser

from manigaussian_tpu.tools import convert_weights as JW
from manigaussian_tpu_torch import convert as TC
from manigaussian_tpu_torch.tools import convert_weights as TW
from tests.test_clip_text import _TorchTextTwin
from tests.test_dinov2 import _TorchDinoTwin
from tests.test_sd_vae import _TorchVaeTwin
from tests.test_torch_clip_text import stand_in_vocab, twin_tokens

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clip_sd():
    torch.manual_seed(0)
    return _TorchTextTwin().clip_state_dict()


def _dino_sd():
    torch.manual_seed(1)
    return _TorchDinoTwin().clip_state_dict()


def _vae_ckpt():
    torch.manual_seed(0)
    sd = _TorchVaeTwin().state_dict_compat()
    return {"state_dict": {f"first_stage_model.{k}": v
                           for k, v in sd.items()}}


CHECKPOINTS = {"clip": _clip_sd, "dinov2": _dino_sd, "sd_vae": _vae_ckpt}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """tower → (torch checkpoint, JAX tool's .msgpack, port tool's)."""
    d = tmp_path_factory.mktemp("towers")
    out = {}
    for name, make in CHECKPOINTS.items():
        ckpt = str(d / f"{name}.pt")
        torch.save(make(), ckpt)
        j, t = str(d / f"{name}_jax.msgpack"), str(d / f"{name}_port.msgpack")
        getattr(JW, f"convert_{name}")(ckpt, j)
        getattr(TW, f"convert_{name}")(ckpt, t)
        out[name] = (ckpt, j, t)
    return out


def _outputs(name, path, tmp_path):
    """The port tower loaded from `path` (a checkpoint or a .msgpack), its
    outputs on fixed inputs, on the CPU."""
    if name == "clip":
        from manigaussian_tpu_torch.data.language import ClipRN50TextModel
        vocab = stand_in_vocab(tmp_path / "bpe.txt.gz")
        m = ClipRN50TextModel(path, bpe_path=vocab, device="cpu").model
        with torch.no_grad():
            return m(torch.from_numpy(twin_tokens()))
    rgb = torch.linspace(0, 1, 2 * 16 * 16 * 3).reshape(2, 16, 16, 3)
    if name == "dinov2":
        from manigaussian_tpu_torch.models.dinov2 import DinoV2Extractor
        return DinoV2Extractor(path, device="cpu")(rgb)
    from manigaussian_tpu_torch.models.foundation import \
        SDVaeFeatureExtractor
    return SDVaeFeatureExtractor(path, feature_hw=32, device="cpu")(rgb)


@pytest.mark.parametrize("name", list(CHECKPOINTS))
def test_jax_msgpack_loads_in_the_port_bit_for_bit(files, name, tmp_path):
    ckpt, jax_file, _ = files[name]
    direct = _outputs(name, ckpt, tmp_path)
    converted = _outputs(name, jax_file, tmp_path)
    for a, b in zip(torch.utils._pytree.tree_leaves(direct),
                    torch.utils._pytree.tree_leaves(converted)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", list(CHECKPOINTS))
def test_port_writes_the_jax_tools_bytes(files, name):
    _, jax_file, port_file = files[name]
    with open(jax_file, "rb") as f:
        want = f.read()
    with open(port_file, "rb") as f:
        got = f.read()
    assert got == want
    theirs, ours = JW.load_converted(port_file), TW.load_converted(jax_file)
    assert theirs["tower"] == ours["tower"] and theirs["dims"] == ours["dims"]
    import jax
    lj = jax.tree_util.tree_leaves_with_path(theirs["variables"])
    lt = jax.tree_util.tree_leaves_with_path(ours["variables"])
    assert [p for p, _ in lj] == [p for p, _ in lt]
    for (_, a), (_, b) in zip(lj, lt):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def test_inverse_maps_round_trip_bit_for_bit():
    from manigaussian_tpu_torch.models.clip_text import \
        load_openai_state_dict
    from manigaussian_tpu_torch.models.sd_vae import strip_compvis_prefix
    clip = load_openai_state_dict(_clip_sd())
    back = TC.clip_text_state_dict(TC.clip_text_variables(clip))
    assert back.keys() == clip.keys()
    dino = {k: v for k, v in _dino_sd().items() if k != "mask_token"}
    vae = strip_compvis_prefix(_vae_ckpt()["state_dict"])
    for sd, back in ((clip, back),
                     (dino, TC.dinov2_state_dict(TC.dinov2_variables(dino))),
                     (vae, TC.sd_vae_state_dict(TC.sd_vae_variables(vae)))):
        assert set(back) == set(sd)
        for k in sd:
            assert torch.equal(back[k], sd[k].float()), k


def test_codec_against_flax_and_msgpack(monkeypatch):
    import jax.numpy as jnp
    import msgpack
    tree = {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32,
                     -33, -128, -129, -32768, -32769, -2 ** 31 - 1],
            "scalars": [1.5, True, False, None, "x" * 31, "y" * 40,
                        "z" * 300, b"b" * 10, b"c" * 300],
            "np_scalar": np.float32(3.0), "np_int": np.int64(-7),
            "complex": complex(1.0, -2.0), "empty": np.zeros((0, 3), np.int8),
            "f16": np.arange(6, dtype=np.float16).reshape(2, 3),
            "map": {str(i): i for i in range(20)}, "long": list(range(20))}
    want = fser.msgpack_serialize(tree)
    assert TW.msgpack_serialize(tree) == want
    assert TW.unpackb(msgpack.packb(tree["ints"] + tree["scalars"])) == \
        tree["ints"] + [1.5, True, False, None] + tree["scalars"][4:]
    back = TW.msgpack_restore(want)
    assert back["np_scalar"] == np.float32(3.0) and \
        type(back["np_scalar"]) is np.float32
    assert back["complex"] == complex(1.0, -2.0)
    assert back["empty"].shape == (0, 3) and back["f16"].dtype == np.float16
    with pytest.raises(TypeError, match="tuple"):
        TW.msgpack_serialize({"t": (1, 2)})
    # bfloat16: read as uint16 bits, viewed as torch.bfloat16
    bf = fser.msgpack_serialize({"w": jnp.arange(5, dtype=jnp.bfloat16)})
    w = TW.msgpack_restore(bf)["w"]
    assert w.dtype == torch.bfloat16 and w.tolist() == [0, 1, 2, 3, 4]
    assert TW.msgpack_serialize({"w": w}) == bf
    # arrays past MAX_CHUNK_SIZE travel chunked
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(TW, "MAX_CHUNK_SIZE", 64)
    big = {"a": {"w": np.arange(300, dtype=np.float32).reshape(3, 100)}}
    chunked = fser.msgpack_serialize(big)
    assert TW.msgpack_serialize(big) == chunked
    np.testing.assert_array_equal(TW.msgpack_restore(chunked)["a"]["w"],
                                  big["a"]["w"])


def test_no_msgpack_flax_or_jax_needed(files):
    """The JAX tool's file read, a tower built from it, and written back,
    in a process where msgpack, flax and jax cannot be imported."""
    _, jax_file, _ = files["dinov2"]
    code = (
        "import sys\n"
        "for m in ('msgpack', 'flax', 'jax', 'jaxlib', 'manigaussian_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from manigaussian_tpu_torch.tools import convert_weights as W\n"
        "from manigaussian_tpu_torch.models.dinov2 import DinoV2Extractor\n"
        f"p = {jax_file!r}\n"
        "e = DinoV2Extractor(p, device='cpu')\n"
        "f = e(torch.rand(1, 8, 8, 3))\n"
        "assert W.load_converted(p)['dims']['layers'] == 2\n"
        "raw = W.msgpack_restore(open(p, 'rb').read())\n"
        "assert W.msgpack_serialize(raw) == open(p, 'rb').read()\n"
        "print('ok', tuple(f.shape))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.startswith("ok"), out.stderr


def test_cli_and_t5(files, tmp_path, capsys):
    ckpt = files["dinov2"][0]
    TW.main(["dinov2", ckpt, str(tmp_path / "d.msgpack")])
    assert "[convert] dinov2 tower dims=" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="torch checkpoint"):
        TW.main(["t5", str(tmp_path), str(tmp_path / "t5")])
