"""Mesh-sharded E-step equivalence (8 virtual CPU devices).

The dp x mp shard_map E-step (parallel/estep.py) — mesh-wide
log-sum-exp over the ref axis, on-device posterior weighting, psum'd
count pytree — must reproduce the single-device engine path's totals
and per-read log-likelihoods.  This is the device-mesh analogue of the
reference's distributed-counts merge (addWeighted qmodel.cpp:1656-1673
+ finalCounts qmodel.cpp:2416-2418), exercised the way the loopback
socket tests exercise the reference's remote path (Makefile:158-176).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from quaff_tpu.aligner import DPConfig, FWDBACK_CELL_SIZE  # noqa: E402
from quaff_tpu.alphabet import DNA_ALPHABET  # noqa: E402
from quaff_tpu.dp.counts import dp_forward_backward  # noqa: E402
from quaff_tpu.dp.engine import PairBatch, device_batch, device_tables  # noqa: E402
from quaff_tpu.dp.scores import ScoreTables  # noqa: E402
from quaff_tpu.io.fastseq import FastSeq, KmerIndex  # noqa: E402
from quaff_tpu.model.params import QuaffNullParams, default_params  # noqa: E402
from quaff_tpu.parallel.estep import (  # noqa: E402
    _estep_program,
    build_pair_grid,
    sharded_estep,
)
from quaff_tpu.parallel.mesh import make_mesh  # noqa: E402


def test_sharded_estep_matches_single_device():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices (conftest XLA_FLAGS)")

    rng = np.random.default_rng(41)
    params = default_params()
    tables = ScoreTables.from_params(params)
    tdev = device_tables(tables)
    mesh = make_mesh(8)
    dp, mp = mesh.shape["dp"], mesh.shape["mp"]

    def rand_seq(n):
        return "".join(DNA_ALPHABET[t] for t in rng.integers(0, 4, n))

    refs = [FastSeq(name=f"ref{i}", seq=rand_seq(150)) for i in range(mp)]
    reads = []
    for i in range(dp * 3):
        src = refs[i % mp].seq[10:130]
        toks = [
            int(rng.integers(0, 4)) if rng.random() < 0.04
            else DNA_ALPHABET.index(c)
            for c in src
        ]
        seq = "".join(DNA_ALPHABET[t] for t in toks)
        qual = "".join(chr(33 + int(q)) for q in rng.integers(5, 30, len(seq)))
        reads.append(FastSeq(name=f"read{i}", seq=seq, qual=qual))
    null = QuaffNullParams.fit(reads)
    null_ll = jnp.asarray(
        [null.log_likelihood(y) for y in reads], jnp.float32
    )

    config = DPConfig(sparse=False)
    grid, _ = build_pair_grid(refs, reads, tables, config, FWDBACK_CELL_SIZE)
    counts, loglike, y_ll = sharded_estep(
        mesh, tdev, grid, null_ll, local=True, dtype=jnp.float32,
        num_match_kmers=params.num_match_kmers,
        num_indel_kmers=params.num_indel_kmers,
    )

    # single-device reference: same pair grid, flat batch
    pairs = []
    for y in reads:
        yi = KmerIndex(y, config.kmer_len)
        for x in refs:
            pairs.append((x, y, config.make_envelope(x, yi, FWDBACK_CELL_SIZE)))
    res = dp_forward_backward(
        tdev, device_batch(PairBatch.build(pairs, tables)),
        local=True, dtype=jnp.float32,
        num_match_kmers=params.num_match_kmers,
        num_indel_kmers=params.num_indel_kmers,
    )
    fwd = np.asarray(res["fwd_score"], np.float64).reshape(len(reads), len(refs))
    nll = np.asarray(null_ll, np.float64)
    y_ll_ref = np.array([
        np.logaddexp.reduce(np.concatenate([[nll[r]], fwd[r]]))
        for r in range(len(reads))
    ])
    w = np.exp(fwd - y_ll_ref[:, None]).reshape(-1)

    np.testing.assert_allclose(
        np.asarray(y_ll, np.float64), y_ll_ref, rtol=1e-5, atol=1e-4
    )
    np.testing.assert_allclose(
        float(loglike), y_ll_ref.sum(), rtol=1e-6
    )
    for name in ("match_counts", "insert_counts", "m2m", "m2i", "m2d",
                 "m2e", "i2i", "i2m", "d2d", "d2m"):
        c = np.asarray(res[name], np.float64)
        want = np.tensordot(w, c, axes=(0, 0))
        np.testing.assert_allclose(
            np.asarray(counts[name], np.float64), want,
            rtol=2e-4, atol=2e-4, err_msg=name,
        )
    # posterior-normalised mass check: every read's match+insert counts
    # sum to its emitted length when posteriors sum to 1 over refs+null
    assert float(np.sum(np.asarray(counts["match_counts"]))) > 0

    # a second call on the same grid (the next EM iteration) reuses the
    # compiled mesh program
    sharded_estep(
        mesh, tdev, grid, null_ll, local=True, dtype=jnp.float32,
        num_match_kmers=params.num_match_kmers,
        num_indel_kmers=params.num_indel_kmers,
    )
    step = _estep_program(
        mesh, tuple(sorted(grid)), True, jnp.float32,
        params.num_match_kmers, params.num_indel_kmers,
    )
    assert step._cache_size() == 1
