"""The whole act's share of the chip's bf16 peak (the policy's forward)."""
from benchmark.readers import mfu as read  # noqa: F401
