"""Quantified EM-trajectory drift of the production (f32, exact
posterior weighting) train path vs the f64 parity path.

The mesh train path intentionally diverges from the reference's EM
semantics: every (read, ref) pair's backward pass is computed with the
posterior weight doing the pruning exactly (instead of the Δ=20
running-loglike skip, qmodel.cpp:2252-2255), and the fills run in f32
with per-row posterior renormalisation.  PARITY.md documents the
divergence; this test BOUNDS it over a long (10-iteration) EM run:
the per-iteration log-likelihood series and the final fitted parameters
of the mesh f32 path must track the sequential f64 path within the
asserted tolerances.
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from quaff_tpu.aligner import DPConfig  # noqa: E402
from quaff_tpu.alphabet import DNA_ALPHABET  # noqa: E402
from quaff_tpu.io.fastseq import FastSeq  # noqa: E402
from quaff_tpu.model.params import (  # noqa: E402
    QuaffNullParams,
    QuaffParamCounts,
    default_params,
)
from quaff_tpu.parallel.distributed import make_global_mesh  # noqa: E402
from quaff_tpu.parallel.estep import MeshCountsProvider  # noqa: E402
from quaff_tpu.trainer import QuaffTrainer  # noqa: E402

N_ITERS = 10


def _make_data():
    rng = np.random.default_rng(23)
    refs = []
    for i in range(2):
        seq = "".join(DNA_ALPHABET[t] for t in rng.integers(0, 4, 120))
        refs.append(FastSeq(name=f"ref{i}", seq=seq))
    reads = []
    for i in range(4):
        src = refs[i % 2].seq[5:105]
        toks = [
            int(rng.integers(0, 4)) if rng.random() < 0.08
            else DNA_ALPHABET.index(c)
            for c in src
        ]
        seq = "".join(DNA_ALPHABET[t] for t in toks)
        qual = "".join(chr(33 + int(q)) for q in rng.integers(5, 30, len(seq)))
        reads.append(FastSeq(name=f"read{i}", seq=seq, qual=qual))
    return refs, reads


def _run(refs, reads, params, null, prior, config, provider=None):
    lls = []
    trainer = QuaffTrainer(
        max_iterations=N_ITERS,
        min_fractional_loglike_increment=0.0,  # never converge early
        allow_null_model=True,
    )

    def log(msg):
        if "log-likelihood" in msg:
            lls.append(float(msg.split("(")[1].split(")")[0]))

    qp = trainer.fit(
        refs, reads, params, null, prior, config, log=log,
        counts_provider=provider,
    )
    return qp, lls


def test_em_trajectory_drift_f32_vs_f64():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices (conftest XLA_FLAGS)")
    refs, reads = _make_data()
    params = default_params()
    null = QuaffNullParams.fit(reads)
    prior = QuaffParamCounts.zero(
        params.match_kmer_len, params.indel_kmer_len
    )
    prior.init_counts(9, 9, 5, 1, null)
    config = DPConfig(sparse=False)

    qp64, ll64 = _run(refs, reads, params, null, prior, config)

    mesh = make_global_mesh(1)
    provider = MeshCountsProvider(
        mesh, refs, reads, params, null, config,
        allow_null=True, dtype=jnp.float32,
    )
    qp32, ll32 = _run(refs, reads, params, null, prior, config, provider)

    # EM may (legitimately) stop when the loglike flattens: with
    # min_fractional_loglike_increment=0 the loop breaks on the first
    # strict decrease, and at the flat plateau ulp-level noise decides
    # WHICH plateau iteration ticks down first (the round-4 bitwise table
    # parity fix moved it by 2).  The drift bound below is asserted over
    # the common prefix; the stopping iteration itself is not meaningful,
    # only that both paths reached the plateau and ended at the same LL.
    n = min(len(ll64), len(ll32))
    assert n >= 5, f"trajectories too short ({len(ll64)}, {len(ll32)})"
    assert abs(ll64[-1] - ll32[-1]) < 1e-4 * abs(ll64[-1]), (
        f"paths ended at different loglikes ({ll64[-1]} vs {ll32[-1]})"
    )

    # per-iteration log-likelihood drift: the f32 fills carry ~1e-6
    # relative error per pair; over the run the trajectories must not
    # separate beyond 1e-4 relative (they stay ~1e-5 in practice)
    rel = np.abs(
        (np.asarray(ll32[:n]) - np.asarray(ll64[:n]))
        / np.asarray(ll64[:n])
    )
    assert rel.max() < 1e-4, f"loglike drift {rel.max():.2e} (series {rel})"

    # final fitted params: compare every numeric leaf
    import io

    a = io.StringIO(); qp32.write_json(a)
    b = io.StringIO(); qp64.write_json(b)
    pa, pb = json.loads(a.getvalue()), json.loads(b.getvalue())

    worst = [0.0]

    def walk(x, y, path=""):
        if isinstance(x, dict):
            assert x.keys() == y.keys(), path
            for k in x:
                walk(x[k], y[k], f"{path}/{k}")
        elif isinstance(x, list):
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{path}[{i}]")
        elif isinstance(x, (int, float)) and not isinstance(x, bool):
            d = abs(x - y) / max(abs(y), 1e-9)
            worst[0] = max(worst[0], d)
            assert d < 5e-3, f"{path}: {x} vs {y} (rel {d:.2e})"

    walk(pa, pb)
    # record the measured bound in the assertion message space: params
    # stay well inside 5e-3 relative after 10 f32 EM iterations
    assert worst[0] < 5e-3
