"""The per-layer readers that more than one metric file uses: each takes
the traced run's record (`trace.py`; `host` the untraced window's own
timings, `cfg` the configuration, `training` whether a call is a training
step) and returns a number, or None where the run holds nothing to read."""

from __future__ import annotations

from benchmark.flops import PEAK_BF16, flash_bound_s, model_flops


def idle_share(rec):
    """% of the traced stretch in which no kernel, copy or fill ran."""
    if not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])


def launches_per_call(rec):
    """Kernel launches a traced call (copies and fills not counted)."""
    return rec["kernels"] / rec["calls"] if rec.get("kernels") else None


def range_ms(rec, name: str):
    """Device time a traced call of the kernels inside the program's range
    `name` (a name that ends in "/": every range under it)."""
    spans = [s for n, s in rec.get("range_device_s", {}).items()
             if n == name or (name.endswith("/") and n.startswith(name))]
    return sum(spans) / rec["calls"] * 1e3 if spans else None


def flash_roofline(rec):
    """% of their roofline the flash kernels reach a call: the least time
    of the policy's `transformer_depth` calls (a training step's forward
    with its dropout mask and backward, an act's forward without dropout;
    `flops.flash_bound_s`) over the kernels named `flash*`."""
    m = rec["cfg"].method
    spent = sum(s for n, s in rec.get("kernel_s_by_name", {}).items()
                if "flash" in n) / rec["calls"]
    if spent <= 0:
        return None
    b = flash_bound_s(m, training=rec["training"])
    return 100.0 * m.transformer_depth * sum(b.values()) / spent


def mfu(rec):
    """% of the chip's bf16 peak the whole call reaches: the matrix-product
    FLOPs a call (`flops.model_flops`; a step's forward and backward, an
    act's forward) over the untraced window's mean call time × 989
    TFLOP/s."""
    call_s = rec["host"]["call_ms_mean"] * 1e-3
    return 100.0 * model_flops(rec["cfg"], training=rec["training"]) / (
        call_s * PEAK_BF16)
