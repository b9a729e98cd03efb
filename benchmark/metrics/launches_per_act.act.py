"""Kernel launches an act in the traced stretch (copies and fills not
counted): the host's dispatch work."""
from benchmark.readers import launches_per_call as read  # noqa: F401
