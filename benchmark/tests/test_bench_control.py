"""The control — the plain reference one precision below the
configuration's (float8 operands where the configuration states bfloat16)
in the program's place — fails the cells' output check, and the program
passes it, at micro widths on the CPU with the published precision. On the
card the same readings (`calibrate.py`) set the limits at the cells' own
sizes."""

import pytest

from bench_micro import context, micro_base

from benchmark import correct
from benchmark.entries import act as act_entry
from benchmark.entries import train as train_entry
from benchmark.reference.agent import control_compute


@pytest.fixture
def base(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    return micro_base(str(tmp_path / "copy"), policy_dtype="bfloat16")


@pytest.mark.parametrize("entry,cell", [(train_entry, "w_geo.train"),
                                        (act_entry, "w_geo.act"),
                                        (train_entry, "gnfactor_bc.train")])
def test_control_fails_and_program_passes(entry, cell, base):
    ctx = context(base, cell)
    limits = ctx.workload["limits"]
    program = entry.calibrate(ctx, None)["numbers"]
    assert correct.judge(program, limits)[0], program
    ctx = context(base, cell)
    control = entry.calibrate(ctx, control_compute("bfloat16"))["numbers"]
    assert not correct.judge(control, limits)[0], control
