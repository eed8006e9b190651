"""Worker process for the 2-process jax.distributed loopback test.

Run as: python _mp_estep_worker.py <process_id> <coordinator_port> <out.npz>

Each process owns 4 virtual CPU devices; the two processes form one
8-device (dp=4, mp=2) global mesh and run the sharded E-step
(parallel/estep.py) over a deterministic pair grid.  Process 0 writes
the (replicated) count totals and the total log-likelihood to out.npz.
This is the device-mesh analogue of the reference's loopback `-remote
localhost:PORT` distributed test (Makefile:158-176): a REAL second
process, real cross-process collectives, results asserted against the
single-process path by the parent test.
"""

import os
import sys


def main() -> None:
    pid = int(sys.argv[1])
    port = sys.argv[2]
    out_path = sys.argv[3]

    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=4 "
        + os.environ.get("XLA_FLAGS", "")
    )
    import jax

    jax.config.update("jax_platforms", "cpu")

    from quaff_tpu.parallel.distributed import (
        init_distributed,
        make_global_mesh,
    )

    init_distributed(
        coordinator_address=f"127.0.0.1:{port}", num_processes=2,
        process_id=pid,
    )
    assert jax.process_count() == 2

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from quaff_tpu.aligner import DPConfig, FWDBACK_CELL_SIZE
    from quaff_tpu.dp.engine import device_tables
    from quaff_tpu.dp.scores import ScoreTables
    from quaff_tpu.model.params import QuaffNullParams, default_params
    from quaff_tpu.parallel.estep import build_pair_grid, sharded_estep

    refs, reads = make_data()
    params = default_params()
    tables = ScoreTables.from_params(params)
    tdev = device_tables(tables)
    null = QuaffNullParams.fit(reads)
    null_ll_host = np.asarray(
        [null.log_likelihood(y) for y in reads], np.float32
    )

    mesh = make_global_mesh(mp=2)
    config = DPConfig(sparse=False)
    grid, _ = build_pair_grid(refs, reads, tables, config, FWDBACK_CELL_SIZE)

    # promote the (identical-on-every-process) host grid to global arrays
    def globalize(arr, spec):
        host = np.asarray(arr)
        return jax.make_array_from_callback(
            host.shape, NamedSharding(mesh, spec), lambda idx: host[idx]
        )

    grid_g = {k: globalize(v, P("dp", "mp")) for k, v in grid.items()}
    null_g = globalize(null_ll_host, P("dp"))

    counts, loglike, _ = sharded_estep(
        mesh, tdev, grid_g, null_g, local=True, dtype=jnp.float32,
        num_match_kmers=params.num_match_kmers,
        num_indel_kmers=params.num_indel_kmers,
    )
    out = {k: np.asarray(v) for k, v in counts.items()}
    out["loglike"] = np.asarray(loglike)
    if pid == 0:
        np.savez(out_path, **out)
    # both processes must reach shutdown together (collective teardown)
    jax.effects_barrier()


def make_data():
    """Deterministic tiny workload, shared with the parent test."""
    import numpy as np

    from quaff_tpu.alphabet import DNA_ALPHABET
    from quaff_tpu.io.fastseq import FastSeq

    rng = np.random.default_rng(17)

    def rand_seq(n):
        return "".join(DNA_ALPHABET[t] for t in rng.integers(0, 4, n))

    refs = [FastSeq(name=f"ref{i}", seq=rand_seq(90)) for i in range(2)]
    reads = []
    for i in range(4):
        src = refs[i % 2].seq[5:75]
        toks = [
            int(rng.integers(0, 4)) if rng.random() < 0.05
            else DNA_ALPHABET.index(c)
            for c in src
        ]
        seq = "".join(DNA_ALPHABET[t] for t in toks)
        qual = "".join(chr(33 + int(q)) for q in rng.integers(5, 30, len(seq)))
        reads.append(FastSeq(name=f"read{i}", seq=seq, qual=qual))
    return refs, reads


if __name__ == "__main__":
    main()
