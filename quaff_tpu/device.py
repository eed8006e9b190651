"""Where the device scorers run, how much a device batch may hold, and
where compiled programs are cached.

`device_scorers()` is the one switch between the two routes the
pipelines have: on a GPU backend the align, E-step and overlap scorers
run on the card; on the CPU backend the host-native and float64 parity
routes score instead.
"""

from __future__ import annotations

import collections
import os
import pathlib

# device scorer calls made by this process, by scorer name ("align",
# "estep", "overlap"); also the scorers' warm flags — a scorer that has
# run once has paid its compilation
DISPATCHES: collections.Counter = collections.Counter()

# share of the device memory limit one batch may take: the rest holds
# the score tables, the next batch's inputs and XLA's temporaries
BATCH_MEMORY_FRACTION = 0.5


def device_scorers() -> bool:
    """Do the device scorers run here?  True on a GPU backend."""
    import jax

    return jax.default_backend() == "gpu"


def record_dispatch(scorer: str) -> None:
    DISPATCHES[scorer] += 1


def warm(scorer: str) -> bool:
    """Has this process already run (and so compiled) `scorer`?"""
    return DISPATCHES[scorer] > 0


def memory_limit_bytes() -> int:
    """This process's first device's memory limit
    (`memory_stats()["bytes_limit"]`); backends without memory stats (the
    CPU) report 16 GiB."""
    import jax

    stats = jax.local_devices()[0].memory_stats() or {}
    return int(stats.get("bytes_limit", 16 << 30))


def batch_items(bytes_per_item: float, cap: int) -> int:
    """How many items (pairs or strips) of `bytes_per_item` device bytes
    one batch may hold under the memory budget, as a power of two between
    8 and `cap` (batches are padded to powers of two so that compiled
    shapes stay few)."""
    n = int(memory_limit_bytes() * BATCH_MEMORY_FRACTION // max(bytes_per_item, 1))
    b = 8
    while b * 2 <= min(n, cap):
        b *= 2
    return b


def setup_compile_cache() -> None:
    """Persistent compilation cache: JAX_COMPILATION_CACHE_DIR when it is
    set (JAX reads it itself), else `.jax_cache` at the checkout root."""
    import jax

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    root = pathlib.Path(__file__).resolve().parent.parent
    jax.config.update("jax_compilation_cache_dir", str(root / ".jax_cache"))
