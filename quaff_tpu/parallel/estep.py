"""Sharded batch execution: data-parallel reads x ref-parallel references.

The production-scale E-step: pair arrays carry leading dims [R reads,
K refs]; reads shard over the mesh's "dp" axis, refs over "mp", score
tables replicate.  Inside shard_map each device fills its local pair
block with the banded DP fills, the per-read log-likelihood is reduced
with a mesh-wide log-sum-exp over the ref axis (pmax + psum), posterior
count weighting happens on-device, and the final count pytree is psum'd
over both axes — the mesh equivalent of the reference's client-side
addWeighted/finalCounts merge (qmodel.cpp:2416-2418).

Differences from the sequential-parity path (trainer.py): every pair's
backward pass is computed (posterior weighting makes negligible
contributions harmless) instead of the reference's running-loglike Δ=20
skip, and ref ordering is irrelevant.  The log-likelihood and expected
counts agree with the reference up to that pruning heuristic.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..dp.counts import dp_forward_backward
from ..dp.engine import NEG_INF, dp_fill


def _flatten_rk(tree):
    """[R, K, ...] -> [R*K, ...] for every leaf."""
    return jax.tree_util.tree_map(
        lambda a: a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:]), tree
    )


def sharded_estep(
    mesh: Mesh,
    tables_dev: dict,
    pair_arrays: dict,
    null_loglike: jnp.ndarray,  # [R] per-read null-model log-likelihood
    local: bool = True,
    dtype=jnp.float32,
    num_match_kmers: int = 4,
    num_indel_kmers: int = 1,
    read_mask: jnp.ndarray = None,  # [R] 1.0 = real read, 0.0 = pad
):
    """Full sharded E-step over an [R, K] pair grid.

    Returns (replicated) total count pytree and total log-likelihood, plus
    per-read log-likelihoods [R] (sharded over dp).  `read_mask` excludes
    sentinel/pad reads from the returned log-likelihood in-graph, so the
    total is addressable on every process of a multi-host run (per-read
    y_loglike shards are not).
    """
    if read_mask is None:
        read_mask = jnp.ones_like(null_loglike)
    step = _estep_program(
        mesh, tuple(sorted(pair_arrays)), local, dtype, num_match_kmers,
        num_indel_kmers,
    )
    return step(tables_dev, pair_arrays, null_loglike, read_mask)


_COUNT_FIELDS = (
    "match_counts",
    "insert_counts",
    "m2m",
    "m2i",
    "m2d",
    "m2e",
    "i2i",
    "i2m",
    "d2d",
    "d2m",
)


@functools.lru_cache(maxsize=None)
def _estep_program(mesh, names, local, dtype, num_match_kmers, num_indel_kmers):
    """The mesh E-step as one jitted program, built once per mesh and
    static configuration: run eagerly, shard_map compiles each of the
    body's operations anew on every call (276 programs per `train` run)."""

    def mesh_estep(tables, pairs, null_ll, mask):
        r, k = pairs["y_len"].shape[:2]
        flat = _flatten_rk(pairs)
        res = dp_forward_backward(
            tables,
            flat,
            local=local,
            dtype=dtype,
            num_match_kmers=num_match_kmers,
            num_indel_kmers=num_indel_kmers,
        )
        fwd = res["fwd_score"].reshape(r, k).astype(jnp.float32)
        # per-read loglike: lse over ALL refs (mesh-wide) + the null model
        local_max = jnp.max(fwd, axis=1)
        m = jax.lax.pmax(local_max, "mp")
        m = jnp.maximum(m, null_ll)
        m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
        sum_local = jnp.sum(jnp.exp(fwd - m_safe[:, None]), axis=1)
        sum_all = jax.lax.psum(sum_local, "mp") + jnp.exp(null_ll - m_safe)
        y_loglike = jnp.where(sum_all > 0, m_safe + jnp.log(sum_all), NEG_INF)
        # posterior weight of each (read, ref) pair
        w = jnp.where(
            jnp.isfinite(fwd), jnp.exp(fwd - y_loglike[:, None]), 0.0
        )  # [r, k]
        totals = {}
        for name in _COUNT_FIELDS:
            c = res[name].reshape((r, k) + res[name].shape[1:])
            wc = w.reshape(w.shape + (1,) * (c.ndim - 2)).astype(c.dtype)
            local_sum = jnp.sum(c * wc, axis=(0, 1))
            totals[name] = jax.lax.psum(local_sum, ("dp", "mp"))
        # y_loglike is already replicated over mp; reduce over dp only
        # (masked so sentinel pad reads don't poison the total; f64
        # accumulation where the backend allows it)
        acc = jnp.where(mask > 0, y_loglike, 0.0)
        acc = acc.astype(jnp.float64) if jax.config.jax_enable_x64 else acc
        loglike = jax.lax.psum(jnp.sum(acc), "dp")
        return totals, loglike, y_loglike

    pspec = {name: P("dp", "mp") for name in names}
    return jax.jit(
        jax.shard_map(
            mesh_estep,
            mesh=mesh,
            in_specs=(P(), pspec, P("dp"), P("dp")),
            out_specs=(P(), P(), P("dp")),
            check_vma=False,
        )
    )


def build_pair_grid(
    refs, reads, tables, config, cell_size: int
) -> Tuple[dict, np.ndarray]:
    """Host-side assembly of the [R, K] pair-grid arrays.

    Pads reads to R divisible by the dp axis and refs to K divisible by mp
    (padding pairs get empty envelopes -> -inf scores, zero counts).
    """
    from ..dp.engine import PairBatch
    from ..io.fastseq import KmerIndex

    R, K = len(reads), len(refs)
    pairs = []
    for y in reads:
        y_index = KmerIndex(y, config.kmer_len)
        for x in refs:
            env = config.make_envelope(x, y_index, cell_size)
            pairs.append((x, y, env))
    batch = PairBatch.build(pairs, tables)
    from ..dp.engine import device_batch

    flat = device_batch(batch)
    grid = {
        name: jnp.reshape(arr, (R, K) + arr.shape[1:]) for name, arr in flat.items()
    }
    return grid, np.array([len(y.seq) for y in reads])


class MeshCountsProvider:
    """Mesh data-parallel E-step provider for trainer.fit(counts_provider=)
    — the device-mesh replacement of farming count jobs to socket/qsub
    workers each EM iteration (QuaffTrainer remote dispatch,
    qmodel.cpp:2034-2120): the [R, K] pair grid shards (dp, mp) over the
    device mesh, params-derived score tables replicate, and the count
    totals come back as one psum'd pytree.

    The pair grid is params-independent (only k-mer lengths matter), so
    it is built ONCE here and reused every iteration; per iteration only
    the score tables are recomputed and shipped.  Reads are padded to a
    multiple of the dp axis with sentinel entries whose null
    log-likelihood is +1e30 — their posterior weights are exactly zero
    — and they are excluded from the returned
    log-likelihood.  Every (read, ref) pair is computed: the
    reference's Δ=20 ref skip (qmodel.cpp:2252-2255) becomes an exact
    negligible posterior weight, so sort_order passes through unchanged.
    """

    def __init__(self, mesh, refs, reads, seed_params, null_model, config,
                 allow_null=True, dtype=jnp.float32):
        from ..aligner import FWDBACK_CELL_SIZE
        from ..dp.scores import ScoreTables
        from ..io.fastseq import FastSeq

        self.mesh = mesh
        self.refs = refs
        self.n_reads = len(reads)
        self.dtype = dtype
        self.mk = seed_params.match_kmer_len
        self.ik = seed_params.indel_kmer_len
        dp = mesh.shape["dp"]
        mp = mesh.shape["mp"]
        if len(refs) % mp:
            raise ValueError(
                f"number of references ({len(refs)}) must divide the mesh "
                f"mp axis ({mp}); use -meshmp 1 to replicate refs"
            )
        pad = (-len(reads)) % dp
        padded = list(reads) + [
            FastSeq(name=f"__pad{i}", seq="ACGT", qual="IIII")
            for i in range(pad)
        ]
        null_ll = [
            null_model.log_likelihood(y) if allow_null else -1e30
            for y in reads
        ] + [1e30] * pad  # sentinel: posterior weight exactly 0
        tables = ScoreTables.from_params(seed_params)
        mask = np.asarray([1.0] * len(reads) + [0.0] * pad, np.float32)
        null_np = np.asarray(null_ll, np.float32)
        sharded = self._build_grid_sharded(
            mesh, refs, padded, tables, config, null_np, mask
        )
        if not sharded:
            # single process (or an unsupported device layout): build the
            # full grid and let each process donate its devices' shards
            # (parallel/distributed.global_array)
            from .distributed import global_array

            grid, _ = build_pair_grid(
                refs, padded, tables, config, FWDBACK_CELL_SIZE
            )
            self.grid = {
                name: global_array(mesh, P("dp", "mp"), arr)
                for name, arr in grid.items()
            }
            self.null_ll = global_array(mesh, P("dp"), null_np)
            self.read_mask = global_array(mesh, P("dp"), mask)

    def _build_grid_sharded(self, mesh, refs, padded, tables, config,
                            null_np, mask) -> bool:
        """Multi-host pair-grid assembly: each host builds ONLY its own
        dp-shard of the reads (host prep and memory scale 1/nprocs — the
        cluster-scale input pipeline, replacing the reference's S3/rsync data
        staging qmodel.cpp:1062-1085).  Global shape agreement: row/ref
        padding is derived from the (replicated, cheap) sequence lists,
        and the band width is an allgathered max over the hosts' local
        envelopes.  Returns False when the device layout does not give
        every process a contiguous block of dp rows (the caller then
        falls back to the replicated full build)."""
        import jax

        nprocs = jax.process_count()
        dp, mp = mesh.shape["dp"], mesh.shape["mp"]
        ldev = jax.local_device_count()
        R, K = len(padded), len(refs)
        if (
            nprocs == 1
            or ldev % mp
            or dp % nprocs
            or dp != (ldev // mp) * nprocs
            or R % dp
        ):
            return False
        from jax.experimental import multihost_utils
        from jax.sharding import NamedSharding

        from ..aligner import FWDBACK_CELL_SIZE
        from ..dp.engine import PairBatch, host_batch
        from ..io.fastseq import KmerIndex

        pid = jax.process_index()
        rpp = R // nprocs  # reads per process (contiguous dp block)
        local_reads = padded[pid * rpp : (pid + 1) * rpp]
        pairs = []
        for y in local_reads:
            y_index = KmerIndex(y, config.kmer_len)
            for x in refs:
                pairs.append(
                    (x, y, config.make_envelope(x, y_index, FWDBACK_CELL_SIZE))
                )
        # global padded dims: Lx/Ly from the replicated sequence lists,
        # band width from an allgathered max of the local envelopes
        w_local = max(e.band_width for _, _, e in pairs)
        w_g = int(
            np.max(multihost_utils.process_allgather(jnp.asarray(w_local)))
        )
        lx_g = max(len(x.seq) for x in refs)
        ly_g = max(len(y.seq) for y in padded)
        flat = host_batch(
            PairBatch.build(
                pairs, tables, width=w_g, max_y_len=ly_g, max_x_len=lx_g
            )
        )
        self.grid = {}
        for name, arr in flat.items():
            local = np.reshape(arr, (rpp, K) + arr.shape[1:])
            self.grid[name] = jax.make_array_from_process_local_data(
                NamedSharding(mesh, P("dp", "mp")), local,
                (R, K) + arr.shape[1:],
            )
        sh_r = NamedSharding(mesh, P("dp"))
        self.null_ll = jax.make_array_from_process_local_data(
            sh_r, null_np[pid * rpp : (pid + 1) * rpp], (R,)
        )
        self.read_mask = jax.make_array_from_process_local_data(
            sh_r, mask[pid * rpp : (pid + 1) * rpp], (R,)
        )
        return True

    def __call__(self, qp, sort_order):
        from ..dp.engine import device_tables
        from ..dp.scores import ScoreTables
        from ..model.params import QuaffCounts, QuaffParamCounts

        from .distributed import global_array

        tables = ScoreTables.from_params(qp)
        tdev = {
            name: global_array(self.mesh, P(), arr)
            for name, arr in device_tables(tables).items()
        }
        totals, loglike_g, _ = sharded_estep(
            self.mesh, tdev, self.grid, self.null_ll,
            local=True, dtype=self.dtype,
            num_match_kmers=qp.num_match_kmers,
            num_indel_kmers=qp.num_indel_kmers,
            read_mask=self.read_mask,
        )
        loglike = float(loglike_g)
        qc = QuaffCounts(
            match_kmer_len=self.mk,
            indel_kmer_len=self.ik,
            insert=np.asarray(totals["insert_counts"], np.float64),
            match=np.asarray(totals["match_counts"], np.float64),
            m2m=np.asarray(totals["m2m"], np.float64),
            m2i=np.asarray(totals["m2i"], np.float64),
            m2d=np.asarray(totals["m2d"], np.float64),
            m2e=np.asarray(totals["m2e"], np.float64),
            d2d=float(totals["d2d"]),
            d2m=float(totals["d2m"]),
            i2i=float(totals["i2i"]),
            i2m=float(totals["i2m"]),
        )
        return QuaffParamCounts.from_counts(qc), loglike, sort_order


def gather_scores(scores) -> np.ndarray:
    """Fetch a dp-sharded score array to every host: plain np.asarray on
    one controller, an allgather across the processes of a multi-host
    cluster (sharded shards are not host-addressable there)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(scores, tiled=True))
    return np.asarray(scores)


def _engine_scores(tables, batch, mode, local, dtype):
    return dp_fill(
        tables, batch, mode=mode, local=local, return_matrices=False,
        dtype=dtype,
    )["score"]


def _kernel_scores(tables, batch, local, reach):
    from ..dp.align_kernel import viterbi_scores

    return viterbi_scores(tables, batch, local=local, reach=reach)


def _overlap_scores(tables, batch):
    from ..dp.overlap import overlap_fill

    return overlap_fill(
        tables, batch, return_matrices=False, dtype=jnp.float32
    )["score"]


@functools.lru_cache(maxsize=None)
def _chunk_program(mesh, names, scorer, static):
    """`scorer(tables, chunk, *static)` over a [D, B, ...] batch, one chunk
    per device of the mesh's "dp" axis, as one jitted program built once
    per mesh, batch fields, scorer and static arguments."""

    def mesh_scores(tables, bt):
        return scorer(tables, {k: v[0] for k, v in bt.items()}, *static)[None]

    return jax.jit(
        jax.shard_map(
            mesh_scores,
            mesh=mesh,
            in_specs=(P(), {k: P("dp") for k in names}),
            out_specs=P("dp"),
            check_vma=False,
        )
    )


def sharded_align_engine(
    mesh: Mesh,
    tables_dev: dict,
    batch: dict,  # leading axis [D, B, ...]: one pair chunk per device
    mode: str = "viterbi",
    local: bool = True,
    dtype=jnp.float32,
):
    """Mesh-sharded XLA-engine scoring (the f64 parity fills of
    dp/engine.dp_fill inside shard_map over "dp") — the align scoring
    path where the device scorers do not run (the CPU), and the
    byte-parity twin of sharded_align_scores.  Scoring needs no
    collective; returns scores [D, B] sharded over dp."""
    step = _chunk_program(
        mesh, tuple(sorted(batch)), _engine_scores, (mode, local, dtype)
    )
    return step(tables_dev, batch)


def sharded_align_scores(
    mesh: Mesh,
    tables_dev: dict,
    batch: dict,  # leading axis [D, B, ...]: one packed chunk per device
    local: bool = True,
    reach: int = None,
):
    """Mesh-sharded align scoring with the align kernel
    (dp/align_kernel.viterbi_scores) inside a shard_map over the mesh's
    "dp" axis — one lane-packed pair chunk per device.

    The mesh equivalent of farming one read-task per worker
    (runQuaffAlignmentTasks, qmodel.cpp:2870-2882): read chunks shard
    over dp, score tables replicate, and no collective is needed —
    alignment scoring is embarrassingly parallel; winner selection and
    the f64 traceback stay host-side exactly as in the single-device
    aligner (aligner.py).

    Returns pair scores [D, B] (sharded over dp).
    """
    step = _chunk_program(
        mesh, tuple(sorted(batch)), _kernel_scores, (local, reach)
    )
    return step(tables_dev, batch)


def sharded_overlap_scores(
    mesh: Mesh,
    tables_dev: dict,  # overlap_device_tables of one strand
    batch: dict,  # leading axis [D, B, ...]: one strip chunk per device
):
    """Mesh-sharded all-vs-all overlap scoring: overlap_fill (f32,
    score-only) inside a shard_map over the mesh's "dp" axis — one chunk
    of envelope strips per device, pair-emission tables replicated
    (hoisted once per (params, strand), unlike the reference's per-task
    rebuild, qoverlap.cpp:77-79).

    The mesh analogue of the overlap pair scheduler's task farming
    (qoverlap.cpp:554-566): chunks shard over dp; scoring needs no
    collective, and the exact-pass traceback stays host-side as in the
    single-device pipeline (overlap.py).

    Returns strip scores (end + x/y insert scores) [D, B], sharded over dp.
    """
    step = _chunk_program(mesh, tuple(sorted(batch)), _overlap_scores, ())
    return step(tables_dev, batch)
