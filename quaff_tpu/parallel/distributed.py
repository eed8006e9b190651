"""Multi-host runtime initialisation and host-sharded input pipeline.

Scale-out follows the standard JAX multi-controller model: every
process runs the same program, `jax.distributed.initialize` wires the
runtime (the replacement for the reference's ssh bootstrap handshake,
qmodel.cpp:1093-1125), each process loads only its shard of the reads
(replacing S3/rsync data staging, qmodel.cpp:1062-1085), and the global
mesh spans all processes' devices — E-step count psums ride NVLink
between the GPUs of a host and the network between hosts.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialise the multi-host runtime (no-op when single-process).

    With no arguments, relies on the cluster environment (SLURM and the
    like) exactly as jax.distributed does.
    """
    import jax

    if num_processes is not None and num_processes <= 1:
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def is_primary() -> bool:
    """True on the process that owns user-facing output (host 0)."""
    import jax

    try:
        return jax.process_index() == 0
    except Exception:
        return True


def global_array(mesh, spec, host_array):
    """Promote a host array (identical on every process) to a global
    device array sharded by `spec` over `mesh`.

    This is the multi-controller hand-off point: each process donates
    the shards that live on its own devices; jax stitches them into one
    global array usable inside shard_map over the global mesh.
    """
    import jax
    from jax.sharding import NamedSharding

    host = np.asarray(host_array)
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(host, sharding)
    return jax.make_array_from_callback(
        host.shape, sharding, lambda idx: host[idx]
    )


def host_read_shard(reads: List, process_id: Optional[int] = None,
                    num_processes: Optional[int] = None) -> List:
    """This host's shard of the read list (contiguous block partitioning,
    matching the dp-axis order of parallel.estep)."""
    import jax

    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if num_processes is None else num_processes
    per = -(-len(reads) // n)
    return reads[pid * per : (pid + 1) * per]


def make_global_mesh(mp: int = 1):
    """A (dp, mp) mesh over every device of every host."""
    import jax
    from jax.sharding import Mesh

    devices = np.array(jax.devices())
    dp = len(devices) // mp
    return Mesh(devices[: dp * mp].reshape(dp, mp), ("dp", "mp"))
