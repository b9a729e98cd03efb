"""Device time a step of the kernels inside the rasterizer's ranges
`rasterize/{preprocess,bin_sort,gather,blend}` (the renders' forward; their
backward runs on autograd's thread)."""

from benchmark.readers import range_ms


def read(rec):
    return range_ms(rec, "rasterize/")
