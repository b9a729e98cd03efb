"""Device time a step of the kernels that start inside the program's
`update/forward` range (the policy, the regressor and the renders' forward;
the backward runs on autograd's thread, outside it)."""

from benchmark.readers import range_ms


def read(rec):
    return range_ms(rec, "update/forward")
