"""RPC bridge for running the simulator on a separate host (a copy of
`manigaussian_tpu/envs/rpc.py`; the wire protocol is the contract between
the two packages: a client of either talks to a server of either).

CoppeliaSim/RLBench is an x86 CPU process (the PyRep/CFFI layer stays
host-side); the GPU host's eval talks to it over this bridge:

    sim host:  python -m manigaussian_tpu_torch.sim_host_server \
                   --port 18861 --backend rlbench --dataset-root /data/demos
    GPU host:  python -m manigaussian_tpu_torch.eval ... \
                   --env rpc://simhost:18861

`EnvRPCServer` wraps ANY EnvClient implementation (RLBenchEnvClient on a real
sim host, MockEnvClient in tests) and serves the protocol over TCP.
`RPCEnvClient` implements the same EnvClient protocol on the caller side, so
the eval runner cannot tell local and remote environments apart.

Wire format — one request/response per call, length-prefixed (4-byte
big-endian) JSON; numpy arrays travel as {"__nd__", dtype, shape, data:
base64(raw)} (no pickle: version-stable and safe to expose on a lab network).
Errors on the sim side return {"ok": false, "etype", "error"} and re-raise
client-side as RuntimeError — the eval runner's error-tolerant step semantics
(reference custom_rlbench_env.py:333-344) already convert failures into
terminal transitions.
"""

from __future__ import annotations

import base64
import json
import socket
import struct
import threading
from dataclasses import asdict
from typing import Optional

import numpy as np

from manigaussian_tpu_torch.envs.base import EnvObservation, EnvStepResult

_MAX_MSG = 1 << 30


def _enc(obj):
    if isinstance(obj, np.ndarray):
        return {"__nd__": True, "dtype": str(obj.dtype),
                "shape": list(obj.shape),
                "data": base64.b64encode(np.ascontiguousarray(obj).tobytes()
                                         ).decode("ascii")}
    if isinstance(obj, (np.floating, np.integer, np.bool_)):
        return obj.item()
    if isinstance(obj, EnvObservation):
        return {"__obs__": True, **{k: _enc(v) for k, v in
                                    asdict(obj).items()}}
    if isinstance(obj, EnvStepResult):
        return {"__step__": True,
                "observation": _enc(obj.observation),
                "reward": float(obj.reward),
                "terminal": bool(obj.terminal),
                "info": _enc(obj.info)}
    if isinstance(obj, dict):
        return {k: _enc(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_enc(v) for v in obj]
    return obj


def _dec(obj):
    if isinstance(obj, dict):
        if obj.get("__nd__"):
            raw = base64.b64decode(obj["data"])
            return np.frombuffer(raw, dtype=np.dtype(obj["dtype"])).reshape(
                obj["shape"]).copy()
        if obj.get("__obs__"):
            return EnvObservation(
                rgb=_dec(obj["rgb"]), pcd=_dec(obj["pcd"]),
                low_dim_state=_dec(obj["low_dim_state"]),
                lang_goal=obj.get("lang_goal", ""),
                misc=_dec(obj.get("misc", {})))
        if obj.get("__step__"):
            return EnvStepResult(
                observation=_dec(obj["observation"]),
                reward=float(obj["reward"]), terminal=bool(obj["terminal"]),
                info=_dec(obj.get("info", {})))
        return {k: _dec(v) for k, v in obj.items()
                if k not in ("__obs__", "__step__")}
    if isinstance(obj, list):
        return [_dec(v) for v in obj]
    return obj


def _send_msg(sock: socket.socket, payload: dict) -> None:
    data = json.dumps(payload).encode("utf-8")
    sock.sendall(struct.pack(">I", len(data)) + data)


def _recv_msg(sock: socket.socket) -> Optional[dict]:
    hdr = _recv_exact(sock, 4)
    if hdr is None:
        return None
    (length,) = struct.unpack(">I", hdr)
    if length > _MAX_MSG:
        raise ValueError(f"rpc message too large: {length}")
    data = _recv_exact(sock, length)
    if data is None:
        return None
    return json.loads(data.decode("utf-8"))


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


_METHODS = ("launch", "shutdown", "set_task", "reset_to_demo", "step",
            "ping", "num_episodes")


class EnvRPCServer:
    """Serves one EnvClient over TCP. One connection at a time (the simulator
    is single-scene; the reference likewise runs one env per process)."""

    def __init__(self, env, host: str = "127.0.0.1", port: int = 0):
        self.env = env
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(1)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def serve_forever(self) -> None:
        self._sock.settimeout(0.5)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            with conn:
                self._serve_client(conn)
        self._sock.close()

    def _serve_client(self, conn: socket.socket) -> None:
        while not self._stop.is_set():
            try:
                req = _recv_msg(conn)
            except (ConnectionError, ValueError):
                return
            if req is None:
                return
            method = req.get("method")
            params = _dec(req.get("params", {}))
            try:
                if method not in _METHODS:
                    raise AttributeError(f"unknown rpc method {method!r}")
                if method == "ping":
                    result = "pong"
                elif method == "num_episodes":
                    result = int(getattr(self.env, "num_episodes",
                                         lambda: -1)())
                else:
                    result = getattr(self.env, method)(**params)
                _send_msg(conn, {"ok": True, "result": _enc(result)})
            except Exception as e:  # noqa: BLE001 — forwarded to the client
                _send_msg(conn, {"ok": False, "etype": type(e).__name__,
                                 "error": str(e)})

    def start_background(self) -> "EnvRPCServer":
        self._thread = threading.Thread(target=self.serve_forever, daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


class RPCEnvClient:
    """EnvClient over the wire. Address: 'host:port' or 'rpc://host:port'."""

    def __init__(self, address: str, connect_timeout: float = 30.0):
        addr = address.removeprefix("rpc://")
        host, _, port = addr.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        self.connect_timeout = connect_timeout
        self._sock: Optional[socket.socket] = None

    def _call(self, method: str, **params):
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.connect_timeout)
            self._sock.settimeout(600.0)  # sim steps involve motion planning
        _send_msg(self._sock, {"method": method, "params": _enc(params)})
        resp = _recv_msg(self._sock)
        if resp is None:
            raise ConnectionError("rpc server closed the connection")
        if not resp.get("ok"):
            raise RuntimeError(
                f"rpc {method} failed on sim host: "
                f"{resp.get('etype')}: {resp.get('error')}")
        return _dec(resp.get("result"))

    # EnvClient protocol -----------------------------------------------------
    def launch(self) -> None:
        self._call("launch")

    def shutdown(self) -> None:
        try:
            self._call("shutdown")
        finally:
            if self._sock is not None:
                self._sock.close()
                self._sock = None

    def set_task(self, task_name: str) -> None:
        self._call("set_task", task_name=task_name)

    def reset_to_demo(self, episode_index: int) -> EnvObservation:
        return self._call("reset_to_demo", episode_index=int(episode_index))

    def step(self, action: np.ndarray) -> EnvStepResult:
        return self._call("step", action=np.asarray(action))

    def ping(self) -> str:
        return self._call("ping")
