"""Task-uniform replay buffer (port of `manigaussian_tpu/data/replay.py`;
YARR `task_uniform_replay_buffer.py`): in memory, or under a save_dir in
the native record store (the default: one mmap'd log per task,
`<save_dir>/<task>/records.{bin,idx}`, `data/native_store.py`) or one
pickle file per transition (`<save_dir>/<task>/<i>.replay`, the reference
layout). Both layouts are the JAX package's, byte for byte, so either
package reads a directory the other wrote. Without a C++ compiler the
native store falls back to the pickle layout with a warning, as in JAX.

Sampling picks a task uniformly, then a transition uniformly within it;
`shard=(rank, n)` takes every n-th transition of each task. A transition
read from the store owns its arrays (the codec copies them out of the
mapping).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from manigaussian_tpu_torch.data.native_store import (NativeRecordStore,
                                                      decode_transition,
                                                      encode_transition,
                                                      load_library)

Transition = Dict[str, np.ndarray]


class TaskUniformReplay:
    def __init__(self, save_dir: Optional[str] = None,
                 shard: tuple = (0, 1), storage: str = "native"):
        """storage: 'native' = the C++ mmap record store (falls back to
        pickle if the toolchain is missing); 'pickle' = one file per
        transition (reference layout). Only a save_dir uses either."""
        self.save_dir = save_dir
        self.rank, self.num_replicas = shard
        self._mem: Dict[str, List[Transition]] = {}
        self._disk: Dict[str, List[str]] = {}
        self._stores: Dict[str, NativeRecordStore] = {}
        self.storage = storage
        if storage == "native" and save_dir and load_library() is None:
            self.storage = "pickle"
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)

    def _store(self, task: str) -> NativeRecordStore:
        if task not in self._stores:
            self._stores[task] = NativeRecordStore(
                os.path.join(self.save_dir, task, "records"))
        return self._stores[task]

    def add(self, task: str, transition: Transition) -> None:
        if self.save_dir and self.storage == "native":
            self._store(task).append(encode_transition(transition))
        elif self.save_dir:
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
        return sorted(set(self._mem) | set(self._disk) | set(self._stores))

    def size(self, task: Optional[str] = None) -> int:
        def one(t):
            n = len(self._mem.get(t, [])) + len(self._disk.get(t, []))
            if t in self._stores:
                n += len(self._stores[t])
            return n
        return one(task) if task is not None else sum(one(t) for t in self.tasks)

    def flush(self) -> None:
        """Close the stores' writers (fsync) and map what they wrote."""
        for s in self._stores.values():
            s.flush()

    def reload_from_disk(self) -> None:
        """Re-index an existing save_dir (resume): a task directory with a
        record log opens it (native storage), any other is indexed by its
        pickles."""
        if not self.save_dir:
            return
        self._disk.clear()
        for s in self._stores.values():
            s.close()
        self._stores.clear()
        for task in sorted(os.listdir(self.save_dir)):
            d = os.path.join(self.save_dir, task)
            if not os.path.isdir(d):
                continue
            if (self.storage == "native"
                    and os.path.exists(os.path.join(d, "records.idx"))):
                self._store(task)
                continue
            files = [f for f in os.listdir(d) if f.endswith(".replay")]
            files.sort(key=lambda s: int(s.split(".")[0]))
            self._disk[task] = [os.path.join(d, f) for f in files]

    def _indices(self, task: str) -> List[int]:
        idxs = list(range(self.size(task)))
        return idxs[self.rank::self.num_replicas] or idxs

    def _get(self, task: str, idx: int) -> Transition:
        """Memory first, then the record store, then the pickles."""
        mem = self._mem.get(task, [])
        if idx < len(mem):
            return mem[idx]
        idx -= len(mem)
        if task in self._stores:
            return decode_transition(self._stores[task].get(idx))
        with open(self._disk[task][idx], "rb") as f:
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
