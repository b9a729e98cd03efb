"""Share of the traced stretch in which no kernel, copy or fill ran on the
device, over the traced acts."""
from benchmark.readers import idle_share as read  # noqa: F401
