"""Recorded-transcript environment: record EnvClient sessions, replay them
(a copy of `manigaussian_tpu/envs/transcript.py`; the two packages read and
write the same JSONL).

Purpose: the sim-facing glue (the RPC server, the eval CLI's
`--env rpc://`, the rollout loop) cannot touch a live CoppeliaSim where
none is installed. A recorded call/response transcript turns that glue into
a conformance-testable surface: record a session against any EnvClient (the
mock; a real RLBench sim host in production, by wrapping the env served by
the sim-host server with --record), then re-drive the full eval stack
against the replayed transcript and require identical behavior. What
remains untested after that is only the PyRep-facing body of
RLBenchEnvClient (reference boundary: helpers/custom_rlbench_env.py:279-392).

Format: JSONL, one record per EnvClient call —
    {"method": str, "params": {...}, "result": ... | "etype"/"error": str}
with numpy payloads in the rpc wire encoding (envs/rpc._enc), so a transcript
is exactly what would have crossed the TCP boundary.

Replay semantics: calls must arrive in the recorded order with the recorded
methods (a mismatch is a conformance failure). `step` params are compared to
the recorded action within `action_atol` — strict=True fails on divergence,
strict=False warns (lets a different policy drive the recorded scene, every
divergence logged in result.info["transcript_divergence"]).
"""

from __future__ import annotations

import json
import warnings
from typing import List, Optional

import numpy as np

from manigaussian_tpu_torch.envs.rpc import _dec, _enc


class TranscriptRecorder:
    """EnvClient wrapper that appends every call/response to a JSONL file."""

    def __init__(self, env, path: str):
        self.env = env
        self.path = path
        self._f = open(path, "w")

    def _record(self, method: str, params: dict):
        try:
            result = getattr(self.env, method)(**params)
        except Exception as e:
            self._f.write(json.dumps(
                {"method": method, "params": _enc(params),
                 "etype": type(e).__name__, "error": str(e)}) + "\n")
            self._f.flush()
            raise
        self._f.write(json.dumps(
            {"method": method, "params": _enc(params),
             "result": _enc(result)}) + "\n")
        self._f.flush()
        return result

    def launch(self) -> None:
        self._record("launch", {})

    def shutdown(self) -> None:
        try:
            self._record("shutdown", {})
        finally:
            self._f.close()

    def set_task(self, task_name: str) -> None:
        self._record("set_task", {"task_name": task_name})

    def reset_to_demo(self, episode_index: int):
        return self._record("reset_to_demo",
                            {"episode_index": int(episode_index)})

    def step(self, action: np.ndarray):
        return self._record("step", {"action": np.asarray(action)})


class TranscriptReplayEnv:
    """EnvClient that replays a recorded transcript (conformance double).

    Serves the recorded responses as long as the caller's method sequence
    matches the recording. Wrap in EnvRPCServer (`python -m
    manigaussian_tpu_torch.sim_host_server --backend transcript`) to
    conformance-test the full RPC + eval chain.
    """

    def __init__(self, path: str, strict: bool = True,
                 action_atol: float = 1e-4):
        with open(path) as f:
            self.records: List[dict] = [json.loads(line) for line in f
                                        if line.strip()]
        self.strict = strict
        self.action_atol = action_atol
        self._i = 0
        self.divergences: List[dict] = []

    def _next(self, method: str, params: Optional[dict] = None):
        if self._i >= len(self.records):
            raise RuntimeError(
                f"transcript exhausted at call {self._i} ({method!r}): the "
                "caller made more env calls than the recorded session")
        rec = self.records[self._i]
        self._i += 1
        if rec["method"] != method:
            raise RuntimeError(
                f"transcript conformance failure at call {self._i - 1}: "
                f"recorded {rec['method']!r}, caller sent {method!r}")
        if method == "step" and params is not None:
            recorded = np.asarray(_dec(rec["params"])["action"], np.float64)
            sent = np.asarray(params["action"], np.float64)
            if recorded.shape != sent.shape or not np.allclose(
                    recorded, sent, atol=self.action_atol):
                div = {"call": self._i - 1, "recorded": recorded.tolist(),
                       "sent": sent.tolist()}
                if self.strict:
                    raise RuntimeError(
                        "transcript conformance failure: step action "
                        f"diverged at call {div['call']}: recorded "
                        f"{recorded}, sent {sent} (atol {self.action_atol})")
                self.divergences.append(div)
                warnings.warn(f"transcript action divergence: {div}",
                              stacklevel=3)
        elif method in ("set_task", "reset_to_demo") and params is not None:
            recorded = _dec(rec["params"])
            if recorded != params:
                raise RuntimeError(
                    f"transcript conformance failure at call {self._i - 1}: "
                    f"{method} params {params!r} != recorded {recorded!r}")
        if "etype" in rec:
            raise RuntimeError(
                f"recorded sim-side error: {rec['etype']}: {rec['error']}")
        return _dec(rec.get("result"))

    def launch(self) -> None:
        self._next("launch")

    def shutdown(self) -> None:
        self._next("shutdown")

    def set_task(self, task_name: str) -> None:
        self._next("set_task", {"task_name": task_name})

    def reset_to_demo(self, episode_index: int):
        return self._next("reset_to_demo",
                          {"episode_index": int(episode_index)})

    def step(self, action: np.ndarray):
        return self._next("step", {"action": np.asarray(action)})

    def assert_exhausted(self) -> None:
        """Conformance: the caller replayed the WHOLE session."""
        if self._i != len(self.records):
            raise RuntimeError(
                f"transcript not exhausted: {self._i}/{len(self.records)} "
                "calls replayed")
