"""The last line's schema, the per-layer readers and the trace's
breakdown on a synthetic record."""

import json

import pytest

from benchmark import harness, trace

RECORD = {"calls": 2, "kernels": 200, "window_s": 0.5, "busy_s": 0.2,
          "kernel_s_by_name": {"flash_fwd_bf16_kernel": 1e-3,
                               "flash_bwd_dkdv": 1e-3, "gemm": 0.1},
          "range_device_s": {"update/forward": 0.06, "update/optimizer": 0.02,
                             "rasterize/blend": 0.004,
                             "rasterize/preprocess": 0.002},
          "idle_gaps": {"aten::copy_": 0.1, "aten::mm": 0.2},
          "host": {"call_ms_mean": 250.0, "feed_wait_ms": 0.5},
          "cfg": harness.namespace(harness.load_json("configs", "w_geo")["config"])}


@pytest.mark.parametrize("name", [e["name"] for e in harness.spec()["per_layer"]])
def test_readers(name):
    rec = dict(RECORD, training=name.endswith(".train"))
    v = harness.load_module("metrics", name).read(rec)
    assert v is not None and v > 0
    if name.startswith(("flash_roofline", "mfu", "device_idle")):
        assert v < 100


def test_reader_with_nothing_to_read():
    empty = dict(RECORD, kernel_s_by_name={}, range_device_s={},
                 training=True)
    for name in ("flash_roofline.train", "flash_roofline.act",
                 "render_fwd_device_ms.train", "forward_device_ms.train"):
        assert harness.load_module("metrics", name).read(empty) is None


def test_result_line_schema():
    line = harness.result_line(
        True, 40, 0, {"train_step_ms": {"value": 250.5, "unit": "ms"}},
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
         "memory_peak_bytes": 8_000_000_000, "busy_s": 0.2, "window_s": 0.5},
        [["loss", 1e-3, 2e-2]], trace.breakdown(RECORD))
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert out["checks"] == {"loss": {"value": 1e-3, "limit": 2e-2}}
    assert out["breakdown"]["idle_gaps"][0] == ["aten::mm", 0.2]
    assert len(out["breakdown"]["device_ops"]) <= 10
