"""The benchmark's registry and result line.

Everything that belongs to one cell, configuration, traffic mix or
per-layer metric is a file of its own, found by the name in
`BENCHMARK.json`:

  workloads/<cell>.json    the cell: its config, traffic, entry, chips,
                           start step, limits of the output check
  configs/<config>.json    the configuration as it is run (`config`: the
                           port's whole configuration tree)
  traffic/<mix>.json       the traffic mix: `generator`'s parameters and the
                           loop's
  entries/<entry>.py       the loop a cell's window drives
  metrics/<metric>.py      a per-layer metric: read(record) → a number,
                           or None where the run holds nothing to read
                           (its unit, layer and what it moves are its
                           entry in BENCHMARK.json)

Adding a cell, a configuration, a mix or a metric adds files; nothing here
or in `run.py` changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import types
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules that no run may hold: the JAX stack and the JAX package
# (compared whole: the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "manigaussian_tpu")


def path(kind: str, name: str, ext: str = ".json", base: str = HERE) -> str:
    return os.path.join(base, kind, name + ext)


def load_json(kind: str, name: str, base: str = HERE) -> Dict:
    p = path(kind, name, base=base)
    if not os.path.isfile(p):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({p})")
    with open(p) as f:
        return json.load(f)


def names(kind: str, ext: str = ".json", base: str = HERE) -> List[str]:
    d = os.path.join(base, kind)
    return sorted(f[:-len(ext)] for f in os.listdir(d)
                  if f.endswith(ext) and not f.startswith("_"))


def load_module(kind: str, name: str, base: str = HERE) -> types.ModuleType:
    """`<kind>/<name>.py` as a module (a metric's name holds dots)."""
    p = path(kind, name, ".py", base)
    if not os.path.isfile(p):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({p})")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def spec(base: str = HERE) -> Dict:
    """BENCHMARK.json at the root of the checkout."""
    with open(os.path.join(os.path.dirname(base), "BENCHMARK.json")) as f:
        return json.load(f)


def _in_cell(entry: Dict, cell: str, e2e: List[str]) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") is None or entry["moves"] in e2e


def end_to_end_for(cell: str, base: str = HERE) -> List[str]:
    """The end-to-end metrics the cell reports (an entry without
    `workloads` is reported in every cell)."""
    return [e["name"] for e in spec(base)["end_to_end"]
            if "workloads" not in e or cell in e["workloads"]]


def metrics_for(cell: str, base: str = HERE) -> Dict[str, types.ModuleType]:
    """The per-layer metrics the cell reports, each its reader module: an
    entry's `workloads`, or without it every cell that reports the
    end-to-end metric it moves."""
    e2e = end_to_end_for(cell, base)
    return {e["name"]: load_module("metrics", e["name"], base)
            for e in spec(base)["per_layer"] if _in_cell(e, cell, e2e)}


def namespace(d):
    """A nested dict as attributes (the reference reads the configuration
    so, without the port's dataclasses)."""
    if isinstance(d, dict):
        return types.SimpleNamespace(**{k: namespace(v) for k, v in d.items()})
    if isinstance(d, list):
        return tuple(namespace(v) for v in d)
    return d


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def work_dir(cell: str) -> str:
    """The run's scratch directory under TMPDIR: a fixed path, emptied at
    the start and the end of a run."""
    base = os.environ.get("TMPDIR") or os.path.join(ROOT, "build")
    return os.path.join(base, "manigaussian_bench", cell)


def power_limit() -> Optional[str]:
    """The card's power limit as nvidia-smi reads it (a card set below its
    700 W runs slower under load)."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict,
                device: Dict, checks: List, breakdown: Optional[Dict] = None
                ) -> str:
    """The last line of standard output. `checks`: [name, value, limit]
    of every number compared, under its own key, last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return json.dumps(out)
