"""ctypes binding + transition codec for the native replay record store (a
copy of `manigaussian_tpu/data/native_store.py`; the C++ source is the
package's own copy, `native/replay_store.cpp`).

The C++ side owns the file format: a single append-only log per task +
int64 offset index, mmap'd for zero-syscall random reads, in place of the
reference's one-pickle-per-transition layout
(task_uniform_replay_buffer.py:54). This module:

  * builds the shared library at first use (g++ -O3 -shared) into
    `build/torch_native/` at the repository root (listed in .gitignore),
    named by a hash of the source and the flags, so an edited source is
    rebuilt and an unchanged one loaded as it is;
  * encodes transitions without pickle: numeric arrays via a tiny header
    (name, dtype, shape) + raw bytes, strings/path-lists via JSON — the
    same bytes as the JAX package's codec, so a store written by either
    package reads back in the other.

`NativeRecordStore.get` returns a memoryview into the mapping, which dies
when the reader is remapped (the first read after an append) or the store
is closed; `decode_transition` copies every array out of it.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import json
import os
import struct
import subprocess
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "native" / "replay_store.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libreplay_store-{h.hexdigest()[:16]}.so"


def _build_lib() -> Optional[str]:
    lib = library_path()
    if lib.exists():
        return str(lib)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        import warnings
        warnings.warn(f"native replay store build failed ({e}); "
                      "falling back to pure-python storage")
        return None
    os.replace(tmp, lib)
    return str(lib)


def load_library():
    global _lib
    if _lib is not None:
        return _lib
    path = _build_lib()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.rs_writer_open.restype = ctypes.c_void_p
    lib.rs_writer_open.argtypes = [ctypes.c_char_p]
    lib.rs_writer_add.restype = ctypes.c_int64
    lib.rs_writer_add.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_int64]
    lib.rs_writer_count.restype = ctypes.c_int64
    lib.rs_writer_count.argtypes = [ctypes.c_void_p]
    lib.rs_writer_close.argtypes = [ctypes.c_void_p]
    lib.rs_reader_open.restype = ctypes.c_void_p
    lib.rs_reader_open.argtypes = [ctypes.c_char_p]
    lib.rs_reader_count.restype = ctypes.c_int64
    lib.rs_reader_count.argtypes = [ctypes.c_void_p]
    lib.rs_reader_get.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.rs_reader_get.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.POINTER(ctypes.c_int64)]
    lib.rs_reader_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


# ------------------------------------------------------------------ codec
_MAGIC = b"MGTR1\x00"


def encode_transition(tr: Dict) -> bytes:
    """dict of {ndarray | str | list-of-str | scalar} → bytes (no pickle)."""
    arrays = {}
    meta = {}
    for k, v in tr.items():
        if isinstance(v, np.ndarray) and v.dtype != object:
            arrays[k] = v
        elif isinstance(v, np.ndarray):  # object array of path strings
            meta[k] = {"__paths__": [str(x) for x in v.tolist()]}
        elif isinstance(v, (np.bool_, np.floating, np.integer)):
            arrays[k] = np.asarray(v)
        elif v is None:
            meta[k] = {"__none__": True}
        else:
            meta[k] = v
    buf = io.BytesIO()
    buf.write(_MAGIC)
    meta_b = json.dumps(meta).encode()
    buf.write(struct.pack("<q", len(meta_b)))
    buf.write(meta_b)
    buf.write(struct.pack("<q", len(arrays)))
    for k, v in arrays.items():
        kb = k.encode()
        v = np.ascontiguousarray(v)
        header = json.dumps({"dtype": v.dtype.str,
                             "shape": list(v.shape)}).encode()
        buf.write(struct.pack("<q", len(kb)))
        buf.write(kb)
        buf.write(struct.pack("<q", len(header)))
        buf.write(header)
        raw = v.tobytes()
        buf.write(struct.pack("<q", len(raw)))
        buf.write(raw)
    return buf.getvalue()


def decode_transition(data: memoryview) -> Dict:
    assert bytes(data[:6]) == _MAGIC, "bad record magic"
    pos = 6

    def read_i64():
        nonlocal pos
        (v,) = struct.unpack_from("<q", data, pos)
        pos += 8
        return v

    out: Dict = {}
    meta_len = read_i64()
    meta = json.loads(bytes(data[pos:pos + meta_len]))
    pos += meta_len
    for k, v in meta.items():
        if isinstance(v, dict) and "__paths__" in v:
            out[k] = np.array(v["__paths__"], dtype=object)
        elif isinstance(v, dict) and v.get("__none__"):
            out[k] = None
        else:
            out[k] = v
    n = read_i64()
    for _ in range(n):
        klen = read_i64()
        k = bytes(data[pos:pos + klen]).decode()
        pos += klen
        hlen = read_i64()
        h = json.loads(bytes(data[pos:pos + hlen]))
        pos += hlen
        rlen = read_i64()
        arr = np.frombuffer(data[pos:pos + rlen],
                            dtype=np.dtype(h["dtype"])).reshape(h["shape"])
        pos += rlen
        out[k] = arr.copy()  # own the memory (mmap may outlive differently)
    return out


class NativeRecordStore:
    """Python face of the C store: append bytes records / mmap random reads."""

    def __init__(self, path: str):
        self.path = path
        self.lib = load_library()
        if self.lib is None:
            raise RuntimeError("native store unavailable")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._writer = None
        self._reader = None

    def _ensure_writer(self):
        if self._writer is None:
            self._writer = self.lib.rs_writer_open(self.path.encode())
            if not self._writer:
                raise OSError(f"cannot open store writer at {self.path}")

    def _refresh_reader(self):
        if self._reader is not None:
            self.lib.rs_reader_close(self._reader)
        self._reader = self.lib.rs_reader_open(self.path.encode())

    def append(self, record: bytes) -> int:
        self._ensure_writer()
        idx = self.lib.rs_writer_add(self._writer, record, len(record))
        if idx < 0:
            raise OSError("store append failed")
        return int(idx)

    def flush(self):
        if self._writer is not None:
            self.lib.rs_writer_close(self._writer)
            self._writer = None
        self._refresh_reader()

    def __len__(self) -> int:
        if self._writer is not None:
            return int(self.lib.rs_writer_count(self._writer))
        if self._reader is None:
            self._refresh_reader()
        if not self._reader:
            return 0
        return int(self.lib.rs_reader_count(self._reader))

    def get(self, index: int) -> memoryview:
        if self._writer is not None:
            self.flush()
        if self._reader is None:
            self._refresh_reader()
        ln = ctypes.c_int64()
        ptr = self.lib.rs_reader_get(self._reader, index, ctypes.byref(ln))
        if not ptr:
            raise IndexError(index)
        return memoryview((ctypes.c_uint8 * ln.value).from_address(
            ctypes.addressof(ptr.contents))).cast("B")

    def close(self):
        if self._writer is not None:
            self.lib.rs_writer_close(self._writer)
            self._writer = None
        if self._reader is not None:
            self.lib.rs_reader_close(self._reader)
            self._reader = None
