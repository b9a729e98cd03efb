"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cell's CUDA devices (it
exits non-zero without printing a result otherwise). The cell's files are
found by name (`harness.py`). Set-up, the measured window of `--seconds`,
with `--trace 1` a traced stretch after it, then the output check against
the plain reference; the last line of standard output is the result, the
numbers compared and their limits are the last lines of standard error.
Scratch data (demonstrations, replay, language cache) goes to
$TMPDIR/manigaussian_bench/<cell>, removed at the end; the program's kernel
builds stay in the checkout's build/.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _listify(x):
    if isinstance(x, dict):
        return {k: _listify(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_listify(v) for v in x]
    return x


class Context:
    """What an entry reads: the cell's files, the run's arguments, the
    port's configuration and the reference's, the device; `step` and `act`
    are the calls the window drives (a test puts a broken one in)."""

    def __init__(self, torch, cell: str, seed: int, seconds: float,
                 trace: bool, device, base: str = harness.HERE):
        self.torch, self.cell, self.seed = torch, cell, seed
        self.seconds, self.trace, self.device = seconds, trace, device
        self.workload = harness.load_json("workloads", cell, base)
        cfg_file = harness.load_json("configs", self.workload["config"], base)
        self.traffic = harness.load_json("traffic", self.workload["traffic"], base)
        self.work = harness.work_dir(cell)
        tree = json.loads(json.dumps(cfg_file["config"]).replace(
            "$RUN_DIR", self.work))
        from manigaussian_tpu_torch.utils.config_io import from_dict
        self.cfg_port = from_dict(tree)
        if _listify(dataclasses.asdict(self.cfg_port)) != _listify(tree):
            raise ValueError(f"config {self.workload['config']!r} differs "
                             "from the port's configuration tree it builds")
        self.cfg = harness.namespace(tree)
        self.setup_s = None
        self.peak = None
        self.laps = []          # (set-up phase, seconds since start)
        self.window_at = None   # the window's start, wall clock
        self.step = lambda agent, batch, gen: agent.update(batch, gen)
        self.act = lambda agent, obs: agent.act(obs)

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def lap(self, phase: str) -> None:
        """The end of a phase of set-up (printed, so that what varies in
        `setup_s` shows)."""
        self.laps.append((phase, time.perf_counter() - T_START))

    def mark_setup(self) -> None:
        self.sync()
        self.setup_s = time.perf_counter() - T_START
        self.window_at = time.time()

    def read_peak(self) -> None:
        if self.device.type == "cuda":
            self.peak = int(self.torch.cuda.max_memory_allocated(self.device))


def set_environment() -> None:
    """Fixed cache directories inside the checkout. The program otherwise
    runs with its own defaults (precision flags, CPU threads), as its users
    run it; the reference sets its own precision while it computes."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")


def run_cell(ctx: Context, base: str = harness.HERE):
    """Run the cell; returns (result dict fields, checks)."""
    from benchmark import correct as C
    from benchmark import trace as T
    entry = importlib.import_module(
        f"benchmark.entries.{ctx.workload['entry']}")
    shutil.rmtree(ctx.work, ignore_errors=True)
    os.makedirs(ctx.work)
    try:
        out = entry.run(ctx)
    finally:
        shutil.rmtree(ctx.work, ignore_errors=True)
    spec = harness.spec(base)
    units = {e["name"]: e["unit"]
             for e in spec["end_to_end"] + spec["per_layer"]}
    metrics, breakdown, record = {}, None, out["record"]
    if ctx.trace:
        record["cfg"] = ctx.cfg
        for name, mod in harness.metrics_for(ctx.cell, base).items():
            v = mod.read(record)
            if v is not None:
                metrics[name] = {"value": v, "unit": units[name]}
        breakdown = T.breakdown(record)
    else:
        values = dict(out["e2e"], setup_s=ctx.setup_s)
        for name in harness.end_to_end_for(ctx.cell, base):
            metrics[name] = {"value": values[name], "unit": units[name]}
    ok, checks = C.judge(out.get("numbers", {}), ctx.workload["limits"])
    device = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
              "kind": (ctx.torch.cuda.get_device_name(0)
                       if ctx.device.type == "cuda" else "cpu"),
              "count": ctx.workload["chips"], "memory_peak_bytes": ctx.peak}
    if ctx.trace:
        device.update(busy_s=record.get("busy_s", 0.0),
                      window_s=record.get("window_s", 0.0))
    for k, v in sorted(out.get("numbers", {}).items()):
        if k not in ctx.workload["limits"]:
            _log(f"reading {k} {v!r}")
    diagnostics = dict(out.get("diagnostics", {}),
                       setup_phases=[(p, round(t, 3)) for p, t in ctx.laps],
                       window_at=ctx.window_at)
    for k, v in sorted(diagnostics.items()):
        _log(f"diagnostic {k} {v!r}")
    return dict(correct=ok, attempted=out["attempted"], failed=out["failed"],
                metrics=metrics, device=device, breakdown=breakdown), checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    chips = harness.load_json("workloads", args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"{args.workload} needs {chips} CUDA device(s); this machine "
             f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    set_environment()
    ctx = Context(torch, args.workload, args.seed, args.seconds,
                  bool(args.trace), torch.device("cuda", 0))
    try:
        fields, checks = run_cell(ctx)
    except Exception:   # any failure ends the run without a result
        _log(traceback.format_exc())
        return 1
    fields["device"]["power_limit"] = harness.power_limit()
    bad = harness.forbidden_modules()
    if bad:
        _log(f"the run loaded {bad}: no module of the JAX stack or the JAX "
             "package may be loaded")
        return 3
    for name, value, limit in checks:
        _log(f"check {name} {value!r} limit {limit!r}")
    print(harness.result_line(checks=checks, **fields), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
