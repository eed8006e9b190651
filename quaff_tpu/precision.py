"""Scoped float64 enablement.

Golden-parity computations (XLA fills feeding tracebacks and text output)
require f64; the device scorers run in float32 with x64 off (see
cli._setup_jax).  On CPU backends x64 is simply on globally; on a GPU
parity computations run on the CPU device inside this scope.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def x64_scope():
    import jax

    if jax.config.jax_enable_x64:
        yield
        return
    try:
        from jax._src.config import enable_x64

        with enable_x64(True):
            yield
        return
    except ImportError:
        pass
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)
