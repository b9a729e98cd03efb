"""The whole training step's share of the chip's bf16 peak (the trained
model's forward and backward)."""
from benchmark.readers import mfu as read  # noqa: F401
