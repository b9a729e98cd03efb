"""The flash self-attention kernels' share of their roofline an act (the
forward without dropout)."""
from benchmark.readers import flash_roofline as read  # noqa: F401
