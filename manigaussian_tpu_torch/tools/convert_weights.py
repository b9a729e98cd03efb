"""Offline tower-weight conversion: torch checkpoints → flax `.msgpack`
(counterpart of `manigaussian_tpu/tools/convert_weights.py`).

The three pretrained towers, each written as the payload the JAX tool
writes ({"tower", "dims", "variables"}, the variables in flax layout), so a
file from either package loads in both, and the T5 encoder's directory:

  CLIP RN50 text  — OpenAI `RN50.pt` (torch.jit archive or state dict)
  DINOv2 ViT      — torch-hub `dinov2_vit*.pth` state dict
  SD VAE          — CompVis checkpoint (`first_stage_model.*`)
  T5 encoder      — a Hugging Face T5 directory (torch weights) → the
                    directory `FlaxT5EncoderModel.save_pretrained` writes

Usage:
    python -m manigaussian_tpu_torch.tools.convert_weights clip   RN50.pt  clip_text.msgpack
    python -m manigaussian_tpu_torch.tools.convert_weights dinov2 vitl14.pth dinov2.msgpack
    python -m manigaussian_tpu_torch.tools.convert_weights sd_vae sd-v1-4.ckpt sd_vae.msgpack
    python -m manigaussian_tpu_torch.tools.convert_weights t5     /ckpts/t5-base t5_flax/

`method.language_model_checkpoint` and
`method.neural_renderer.foundation_checkpoint` accept the tower outputs
(`load_converted`). `t5` needs no `transformers`: it reads the torch weights
(`model.safetensors`, else `pytorch_model.bin`, not a sharded checkpoint,
through `models/dinov2.read_hf_weights`), renames them as
transformers' torch→flax conversion does (a linear `weight` becomes
`kernel` = weightᵀ, `shared` and `relative_attention_bias` become
`embedding`, the layer norms keep `weight`; `encoder.embed_tokens`, tied to
`shared`, and any decoder or head weights are left out, as the flax encoder
model leaves them), and writes `flax_model.msgpack` with the codec below,
the input's `config.json` with `architectures` set to the encoder model's,
and the input's tokenizer files copied. The port's T5 language provider
reads the torch directory itself, as the JAX package's does.

The format is flax's `msgpack_serialize` / `msgpack_restore`, read and
written here in pure Python (no `msgpack`, no `flax`): msgpack's nil, bool,
int (shortest form), float (double), str, bin, array and map, and three
extension types: 1 an ndarray, whose payload is itself a msgpack array
(shape, dtype name, C-order bytes); 2 a complex number (real, imag); 3 a
numpy scalar, packed as a 0-d ndarray. Arrays over `MAX_CHUNK_SIZE` bytes
travel as {"__msgpack_chunked_array__": True, "shape": {...},
"chunks": {...}} maps. `bfloat16` is no numpy dtype: such an array is read
as uint16 and returned as a `torch.bfloat16` tensor. The writer orders
every dict's keys as `jax.tree_util` rebuilds them (sorted), so it writes
the JAX tool's bytes.
"""

from __future__ import annotations

import argparse
import struct
from typing import Any, Dict

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


# ------------------------------------------------------------- the writer
def _head(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: the fix form below `fix_max`, else the first of
    (code, byte count) whose width holds n."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, width in codes:
        if n < 1 << (8 * width):
            out.append(code)
            out += n.to_bytes(width, "big")
            return
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack_int(out: bytearray, x: int) -> None:
    if 0 <= x < 0x80:
        out.append(x)
    elif -0x20 <= x < 0:
        out += struct.pack(">b", x)
    elif x >= 0:
        for code, fmt, top in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                               (0xce, ">I", 0xffffffff),
                               (0xcf, ">Q", 0xffffffffffffffff)):
            if x <= top:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"int {x} does not fit in msgpack")
    else:
        for code, fmt, low in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                               (0xd2, ">i", -0x80000000),
                               (0xd3, ">q", -0x8000000000000000)):
            if x >= low:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"int {x} does not fit in msgpack")


def _ndarray_bytes(x) -> bytes:
    """flax's `_ndarray_to_bytes`: pack((shape, dtype name, C bytes))."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return packb([list(t.shape), "bfloat16",
                          t.view(torch.uint16).numpy().tobytes()])
        x = t.numpy()
    x = np.asarray(x)
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serializable")
    return packb([list(x.shape), x.dtype.name, x.tobytes("C")])


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    n = len(data)
    if n in fixed:
        out.append(fixed[n])
    else:
        _head(out, n, None, 0, ((0xc7, 1), (0xc8, 2), (0xc9, 4)))
    out += struct.pack(">b", code)
    out += data


def _pack(out: bytearray, x, sort_keys: bool) -> None:
    if x is None:
        out.append(0xc0)
    elif x is True or x is False:
        out.append(0xc3 if x else 0xc2)
    elif type(x) is int:
        _pack_int(out, x)
    elif type(x) is float:
        out.append(0xcb)
        out += struct.pack(">d", x)
    elif type(x) is str:
        b = x.encode("utf-8")
        _head(out, len(b), 0xa0, 0x1f, ((0xd9, 1), (0xda, 2), (0xdb, 4)))
        out += b
    elif isinstance(x, (bytes, bytearray)):
        _head(out, len(x), None, 0, ((0xc4, 1), (0xc5, 2), (0xc6, 4)))
        out += x
    elif isinstance(x, list):
        _head(out, len(x), 0x90, 0x0f, ((0xdc, 2), (0xdd, 4)))
        for v in x:
            _pack(out, v, sort_keys)
    elif isinstance(x, dict):
        _head(out, len(x), 0x80, 0x0f, ((0xde, 2), (0xdf, 4)))
        # a chunked array keeps its own order ("0", "1", ..., "10")
        keys = sorted(x) if sort_keys and CHUNKED not in x else list(x)
        inner = sort_keys and CHUNKED not in x
        for k in keys:
            _pack(out, k, sort_keys)
            _pack(out, x[k], inner)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)))
    elif isinstance(x, complex):
        _pack_ext(out, EXT_COMPLEX, packb([x.real, x.imag]))
    else:
        raise TypeError(f"cannot serialize {type(x).__name__!r}")


def packb(x, sort_keys: bool = False) -> bytes:
    out = bytearray()
    _pack(out, x, sort_keys)
    return bytes(out)


def _chunk(x) -> Dict[str, Any]:
    """flax's `_chunk`: the flat array cut into pieces of MAX_CHUNK_SIZE
    bytes, keyed "0", "1", ..."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else \
        x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.numel() if isinstance(x, torch.Tensor) else flat.size
    return {CHUNKED: True,
            "shape": {str(i): int(s) for i, s in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, n, size))}}


def _chunk_leaves(tree):
    """Oversized arrays chunked, in dicts only (as flax does)."""
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        nbytes = (tree.numel() * tree.element_size()
                  if isinstance(tree, torch.Tensor) else tree.nbytes)
        if nbytes > MAX_CHUNK_SIZE:
            return _chunk(tree)
    return tree


def msgpack_serialize(tree, sort_keys: bool = True) -> bytes:
    """flax's `msgpack_serialize` of a tree of dicts, lists and leaves
    (arrays, numpy scalars, Python scalars, str, bytes), oversized arrays
    chunked; dict keys sorted (a tree `jax.tree_util` rebuilt) or, with
    `sort_keys=False`, in insertion order. A tuple raises, as in flax."""
    return packb(_chunk_leaves(tree), sort_keys=sort_keys)


# ------------------------------------------------------------- the reader
class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.data, self.at, self.raw = memoryview(data), 0, raw

    def take(self, n: int) -> memoryview:
        if self.at + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.at:self.at + n]
        self.at += n
        return b

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def items(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, n: int):
        code = struct.unpack(">b", self.take(1))[0]
        return _ext_unpack(code, bytes(self.take(n)))

    def read(self):
        c = self.take(1)[0]
        if c < 0x80:
            return c
        if c >= 0xe0:
            return c - 0x100
        if c <= 0x8f:
            return self.map_(c & 0x0f)
        if c <= 0x9f:
            return self.items(c & 0x0f)
        if c <= 0xbf:
            return self.str_(c & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if c in simple:
            return simple[c]
        if c in (0xc4, 0xc5, 0xc6):
            return bytes(self.take(self.uint(1 << (c - 0xc4))))
        if c in (0xc7, 0xc8, 0xc9):
            return self.ext(self.uint(1 << (c - 0xc7)))
        if c == 0xca:
            return struct.unpack(">f", self.take(4))[0]
        if c == 0xcb:
            return struct.unpack(">d", self.take(8))[0]
        if 0xcc <= c <= 0xcf:
            return self.uint(1 << (c - 0xcc))
        if 0xd0 <= c <= 0xd3:
            n = 1 << (c - 0xd0)
            return int.from_bytes(self.take(n), "big", signed=True)
        if 0xd4 <= c <= 0xd8:
            return self.ext(1 << (c - 0xd4))
        if c in (0xd9, 0xda, 0xdb):
            return self.str_(self.uint(1 << (c - 0xd9)))
        if c in (0xdc, 0xdd):
            return self.items(self.uint(2 if c == 0xdc else 4))
        if c in (0xde, 0xdf):
            return self.map_(self.uint(2 if c == 0xde else 4))
        raise ValueError(f"msgpack type byte 0x{c:02x} is not used by flax")


def unpackb(data: bytes, raw: bool = False):
    r = _Reader(data, raw)
    out = r.read()
    if r.at != len(data):
        raise ValueError("extra bytes after the msgpack object")
    return out


def _ndarray_from_bytes(data: bytes):
    shape, name, buf = unpackb(data, raw=True)
    if name == b"bfloat16":
        bits = np.frombuffer(buf, np.uint16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, np.dtype(name.decode())).reshape(shape)


def _ext_unpack(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == EXT_COMPLEX:
        re_, im = unpackb(data)
        return complex(re_, im)
    if code == EXT_NPSCALAR:
        x = _ndarray_from_bytes(data)
        return x.reshape(()) if isinstance(x, torch.Tensor) else x[()]
    raise ValueError(f"msgpack extension type {code} is not flax's")


def _unchunk(tree):
    if isinstance(tree, dict):
        if CHUNKED in tree:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            parts = [tree["chunks"][str(i)]
                     for i in range(len(tree["chunks"]))]
            flat = (torch.cat(parts) if isinstance(parts[0], torch.Tensor)
                    else np.concatenate(parts))
            return flat.reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """flax's `msgpack_restore`: the tree, arrays as numpy (bfloat16 as
    torch), chunked arrays joined."""
    return _unchunk(unpackb(data))


# -------------------------------------------------------- the tower files
def load_converted(path: str) -> Dict[str, Any]:
    """A converted `.msgpack` (either package's tool) → {tower, dims,
    variables}; dims as Python ints, floats and tuples, as JAX's
    `load_converted` makes them."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())

    def fix(v):
        if isinstance(v, (list, tuple)) or getattr(v, "ndim", 0) == 1:
            return tuple(int(x) for x in v)
        if isinstance(v, float) or (hasattr(v, "dtype")
                                    and np.issubdtype(v.dtype, np.floating)):
            return float(v)
        return int(v)

    payload["dims"] = {k: fix(v) for k, v in payload["dims"].items()}
    return payload


def _write(out_path: str, tower: str, dims: Dict, variables) -> Dict:
    dims = {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in dims.items()}
    payload = {"tower": tower, "dims": dims, "variables": variables}
    with open(out_path, "wb") as f:
        f.write(msgpack_serialize(payload))
    return payload


def convert_clip(in_path: str, out_path: str) -> Dict[str, Any]:
    from manigaussian_tpu_torch.convert import clip_text_variables
    from manigaussian_tpu_torch.models import clip_text as ct
    sd = ct.load_openai_state_dict(in_path)
    return _write(out_path, "clip_text", ct.model_dims_from_state_dict(sd),
                  clip_text_variables(sd))


def convert_dinov2(in_path: str, out_path: str) -> Dict[str, Any]:
    from manigaussian_tpu_torch.convert import dinov2_variables
    from manigaussian_tpu_torch.models import dinov2 as dv
    sd = dv.load_hub_state_dict(in_path)
    return _write(out_path, "dinov2", dv.dims_from_state_dict(sd),
                  dinov2_variables(sd))


def convert_sd_vae(in_path: str, out_path: str) -> Dict[str, Any]:
    """CompVis SD checkpoint (first_stage_model.*) → SDVae msgpack."""
    from manigaussian_tpu_torch.convert import sd_vae_variables
    from manigaussian_tpu_torch.models import sd_vae as sv
    obj = torch.load(in_path, map_location="cpu")
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else \
        obj.state_dict()
    return _write(out_path, "sd_vae", sv.dims_from_state_dict(sd),
                  sd_vae_variables(sd))


T5_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json",
                      "special_tokens_map.json", "spiece.model",
                      "added_tokens.json")


def t5_encoder_variables(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A torch T5 state dict → the params tree of FlaxT5EncoderModel, as
    transformers' `convert_pytorch_state_dict_to_flax` makes it."""
    if "shared.weight" not in sd:
        raise KeyError("the T5 checkpoint has no shared.weight")
    tree: Dict[str, Any] = {}
    for key, w in sd.items():
        parts = key.split(".")
        if parts[0] not in ("shared", "encoder") or key == \
                "encoder.embed_tokens.weight" or parts[-1] != "weight":
            continue
        if parts[0] == "shared" or parts[-2] == "relative_attention_bias":
            parts[-1] = "embedding"
        elif not parts[-2].endswith("layer_norm"):
            parts[-1], w = "kernel", w.t()
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = w.detach().contiguous()
    return tree


def convert_t5(in_dir: str, out_dir: str) -> str:
    """HF torch T5 dir → the flax T5 encoder dir (flax_model.msgpack,
    config.json, the tokenizer files copied alongside)."""
    import json
    import os
    import shutil

    from manigaussian_tpu_torch.models.dinov2 import read_hf_weights
    os.makedirs(out_dir, exist_ok=True)
    tree = t5_encoder_variables(read_hf_weights(in_dir))
    with open(os.path.join(out_dir, "flax_model.msgpack"), "wb") as f:
        # transformers keeps the torch state dict's order
        f.write(msgpack_serialize(tree, sort_keys=False))
    with open(os.path.join(in_dir, "config.json")) as f:
        config = json.load(f)
    config["architectures"] = ["T5EncoderModel"]
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        f.write(json.dumps(config, indent=2, sort_keys=True) + "\n")
    for name in T5_TOKENIZER_FILES:
        if os.path.isfile(os.path.join(in_dir, name)):
            shutil.copyfile(os.path.join(in_dir, name),
                            os.path.join(out_dir, name))
    return out_dir


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert pretrained tower weights to flax formats")
    parser.add_argument("tower", choices=["clip", "dinov2", "sd_vae", "t5"])
    parser.add_argument("input",
                        help=".pt/.pth/.ckpt file (clip/dinov2/sd_vae) or "
                             "HF dir (t5)")
    parser.add_argument("output",
                        help=".msgpack file (clip/dinov2/sd_vae) or dir (t5)")
    args = parser.parse_args(argv)
    if args.tower == "clip":
        p = convert_clip(args.input, args.output)
        print(f"[convert] clip text tower dims={p['dims']} -> {args.output}")
    elif args.tower == "dinov2":
        p = convert_dinov2(args.input, args.output)
        print(f"[convert] dinov2 tower dims={p['dims']} -> {args.output}")
    elif args.tower == "sd_vae":
        p = convert_sd_vae(args.input, args.output)
        print(f"[convert] sd vae (diffusion features) dims={p['dims']} "
              f"-> {args.output}")
    else:
        convert_t5(args.input, args.output)
        print(f"[convert] t5 encoder -> {args.output}")


if __name__ == "__main__":
    main()
