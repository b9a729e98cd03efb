"""Rollout statistics accumulation (a copy of
`manigaussian_tpu/runners/stat_accumulator.py`; YARR
`yarr/utils/stat_accumulator.py` SimpleAccumulator).

Per-env aggregation of episode returns, lengths and per-error-type counts
(custom_rlbench_env.py:333-344 counts IKError / ConfigurationPathError /
InvalidActionError terminations), under the reference's eval CSV column
names.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List


class SimpleAccumulator:
    def __init__(self, prefix: str = "eval_envs"):
        self.prefix = prefix
        self._returns: Dict[str, List[float]] = defaultdict(list)
        self._lengths: Dict[str, List[int]] = defaultdict(list)
        self._errors: Dict[str, int] = defaultdict(int)

    def add_episode(self, task: str, episode_return: float, length: int,
                    error_type: str | None = None) -> None:
        self._returns[task].append(float(episode_return))
        self._lengths[task].append(int(length))
        if error_type:
            self._errors[error_type] += 1

    def pop(self) -> Dict[str, float]:
        """Summaries with the reference's CSV column names; resets state."""
        out: Dict[str, float] = {}
        tasks = sorted(self._returns)
        for task in tasks:
            rs = self._returns[task]
            key = (f"{self.prefix}/return/{task}" if len(tasks) > 1
                   else f"{self.prefix}/return")
            out[key] = sum(rs) / max(len(rs), 1)
            out[f"{self.prefix}/length/{task}" if len(tasks) > 1
                else f"{self.prefix}/length"] = (
                sum(self._lengths[task]) / max(len(self._lengths[task]), 1))
        for err, count in self._errors.items():
            out[f"{self.prefix}/error/{err}"] = float(count)
        self._returns.clear()
        self._lengths.clear()
        self._errors.clear()
        return out
