"""Device mesh construction for data x ref parallel execution.

The reference's four scale-out backends (thread pool, socket remotes,
qsub/NFS, elastic EC2; src/qmodel.h:256-356) collapse into a single
abstraction: a jax.sharding.Mesh with a read data-parallel axis ("dp") and
a reference-set axis ("mp").  Reads shard over dp, references over mp,
parameters/score tables replicate, and E-step count reduction is an
in-XLA psum over both axes (replacing the JSON counts merge,
qmodel.cpp:1656-1679, 2416-2418).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    n_devices: Optional[int] = None, mp: Optional[int] = None
) -> Mesh:
    """Build a (dp, mp) mesh over the first n_devices devices.

    mp defaults to the largest power-of-two divisor of n_devices capped at
    2 (references are usually few; reads are many).
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if mp is None:
        mp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    dp = n_devices // mp
    assert dp * mp == n_devices, f"mesh {dp}x{mp} != {n_devices} devices"
    arr = np.array(devices).reshape(dp, mp)
    return Mesh(arr, ("dp", "mp"))
