"""Task-uniform replay buffer, in memory or one pickle file per transition
(port of `manigaussian_tpu/data/replay.py`; YARR
`task_uniform_replay_buffer.py`).

Sampling picks a task uniformly, then a transition uniformly within it;
`shard=(rank, n)` takes every n-th transition of each task. The JAX
package's native mmap record store (`native/`) is not ported: a save_dir
always uses the pickle layout, which both packages read.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

Transition = Dict[str, np.ndarray]


class TaskUniformReplay:
    def __init__(self, save_dir: Optional[str] = None,
                 shard: tuple = (0, 1)):
        self.save_dir = save_dir
        self.rank, self.num_replicas = shard
        self._mem: Dict[str, List[Transition]] = {}
        self._disk: Dict[str, List[str]] = {}
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)

    def add(self, task: str, transition: Transition) -> None:
        if self.save_dir:
            d = os.path.join(self.save_dir, task)
            os.makedirs(d, exist_ok=True)
            idx = len(self._disk.setdefault(task, []))
            path = os.path.join(d, f"{idx}.replay")
            with open(path, "wb") as f:
                pickle.dump(transition, f, protocol=4)
            self._disk[task].append(path)
        else:
            self._mem.setdefault(task, []).append(transition)

    @property
    def tasks(self) -> List[str]:
        return sorted(set(self._mem) | set(self._disk))

    def size(self, task: Optional[str] = None) -> int:
        def one(t):
            return len(self._mem.get(t, [])) + len(self._disk.get(t, []))
        return one(task) if task is not None else sum(one(t) for t in self.tasks)

    def flush(self) -> None:
        """Nothing is buffered (kept for the JAX interface)."""

    def reload_from_disk(self) -> None:
        """Re-index an existing save_dir (resume)."""
        if not self.save_dir:
            return
        self._disk.clear()
        for task in sorted(os.listdir(self.save_dir)):
            d = os.path.join(self.save_dir, task)
            if not os.path.isdir(d):
                continue
            files = [f for f in os.listdir(d) if f.endswith(".replay")]
            files.sort(key=lambda s: int(s.split(".")[0]))
            self._disk[task] = [os.path.join(d, f) for f in files]

    def _indices(self, task: str) -> List[int]:
        idxs = list(range(self.size(task)))
        return idxs[self.rank::self.num_replicas] or idxs

    def _get(self, task: str, idx: int) -> Transition:
        mem = self._mem.get(task, [])
        if idx < len(mem):
            return mem[idx]
        with open(self._disk[task][idx - len(mem)], "rb") as f:
            return pickle.load(f)

    def sample(self, batch_size: int, rng: np.random.Generator) -> List[Transition]:
        tasks = self.tasks
        assert tasks, "replay is empty"
        out = []
        for _ in range(batch_size):
            task = tasks[rng.integers(len(tasks))]
            idxs = self._indices(task)
            out.append(self._get(task, idxs[rng.integers(len(idxs))]))
        return out


def stack_transitions(transitions: Sequence[Transition]) -> Dict[str, np.ndarray]:
    """Per-sample dicts → stacked arrays (object arrays and strings kept as
    lists for the host-side loader)."""
    out = {}
    for k in transitions[0].keys():
        vals = [t[k] for t in transitions]
        if isinstance(vals[0], np.ndarray) and vals[0].dtype == object:
            out[k] = vals
        elif isinstance(vals[0], (str, type(None))):
            out[k] = vals
        else:
            out[k] = np.stack([np.asarray(v) for v in vals])
    return out
