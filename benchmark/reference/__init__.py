"""Plain reference of the benchmarked configurations (see README.md)."""

import contextlib


@contextlib.contextmanager
def strict_float32(torch):
    """float32 as stated, TF32 off for matmuls and cuDNN, while the
    reference (or the control) computes; the program's own settings come
    back afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
