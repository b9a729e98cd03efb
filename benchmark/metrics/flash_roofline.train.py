"""The flash self-attention kernels' share of their roofline a training
step (the forward with its dropout mask, and the backward)."""
from benchmark.readers import flash_roofline as read  # noqa: F401
