"""Align kernel (dp/align_kernel) equivalence tests: its f32 Viterbi
scores against the f64 XLA fill, in the Pallas interpreter on the CPU."""

import numpy as np
import pytest

import jax.numpy as jnp

from quaff_tpu.alphabet import DNA_ALPHABET
from quaff_tpu.dp.engine import PairBatch, device_batch, device_tables, dp_fill
from quaff_tpu.dp.align_kernel import viterbi_scores
from quaff_tpu.dp.scores import ScoreTables
from quaff_tpu.envelope import full_envelope, sparse_envelope
from quaff_tpu.io.fastseq import FastSeq, KmerIndex
from quaff_tpu.model.params import QuaffParams, default_params


def _random_pairs(rng, n, with_qual=True):
    pairs = []
    for b in range(n):
        xl = int(rng.integers(120, 260))
        yl = int(rng.integers(80, 150))
        xs = "".join(DNA_ALPHABET[t] for t in rng.integers(0, 4, xl))
        start = int(rng.integers(0, xl - yl))
        ys = list(xs[start : start + yl])
        for i in range(len(ys)):
            if rng.random() < 0.1:
                ys[i] = DNA_ALPHABET[int(rng.integers(0, 4))]
        qual = (
            "".join(chr(33 + int(q)) for q in rng.integers(3, 40, yl))
            if with_qual
            else ""
        )
        x = FastSeq(name=f"x{b}", seq=xs)
        y = FastSeq(name=f"y{b}", seq="".join(ys), qual=qual)
        env = sparse_envelope(x, KmerIndex(y, 6), band_size=64, kmer_threshold=14)
        pairs.append((x, y, env))
    return pairs


@pytest.mark.parametrize("layout", ["band", "packed"])
@pytest.mark.parametrize("local", [True, False])
def test_v2_matches_xla(layout, local):
    rng = np.random.default_rng(3)
    tables = ScoreTables.from_params(default_params())
    pairs = _random_pairs(rng, 6)
    pairs[5] = (pairs[5][0], pairs[5][1],
                full_envelope(len(pairs[5][0].seq), len(pairs[5][1].seq)))
    tdev = device_tables(tables)
    ref = np.asarray(
        dp_fill(tdev, device_batch(PairBatch.build(pairs, tables)),
                mode="viterbi", local=local, return_matrices=False,
                dtype=jnp.float64)["score"]
    )
    build = PairBatch.build if layout == "band" else PairBatch.build_packed
    got = np.asarray(
        viterbi_scores(tdev, device_batch(build(pairs, tables)), local=local)
    )
    assert np.isfinite(ref).any()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=0, atol=1e-3)


def test_v2_noqual_and_kmer_contexts():
    rng = np.random.default_rng(11)
    # order-1 gap contexts + order-2 match contexts exercise the indel-
    # context transitions and the wider emission tables
    qp = default_params()
    qp2 = QuaffParams.create(2, 1)
    qp2.ref_base = qp.ref_base
    qp2.extend_insert, qp2.extend_delete = qp.extend_insert, qp.extend_delete
    qp2.begin_insert[:] = qp.begin_insert[0]
    qp2.begin_delete[:] = qp.begin_delete[0]
    qp2.insert_prob, qp2.insert_q, qp2.insert_r = qp.insert_prob, qp.insert_q, qp.insert_r
    for j in range(16):
        qp2.match_prob[:, j] = qp.match_prob[:, j % 4]
        qp2.match_q[:, j] = qp.match_q[:, j % 4]
        qp2.match_r[:, j] = qp.match_r[:, j % 4]
    tables = ScoreTables.from_params(qp2)
    pairs = _random_pairs(rng, 3, with_qual=False)
    bdev = device_batch(PairBatch.build(pairs, tables))
    tdev = device_tables(tables)
    ref = np.asarray(
        dp_fill(tdev, bdev, mode="viterbi", local=True, return_matrices=False,
                dtype=jnp.float64)["score"]
    )
    got = np.asarray(viterbi_scores(tdev, bdev, local=True))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
