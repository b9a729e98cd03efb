"""Device time a step of the kernels inside the program's
`update/optimizer` range (LAMB over every leaf)."""

from benchmark.readers import range_ms


def read(rec):
    return range_ms(rec, "update/optimizer")
