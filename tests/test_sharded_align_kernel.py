"""Mesh align scoring under shard_map (8 virtual CPU devices):
sharded_align_scores runs the align kernel per device chunk; its scores
must equal running viterbi_scores chunk by chunk.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from quaff_tpu.aligner import DPConfig, VITERBI_CELL_SIZE  # noqa: E402
from quaff_tpu.alphabet import DNA_ALPHABET  # noqa: E402
from quaff_tpu.dp.align_kernel import viterbi_scores  # noqa: E402
from quaff_tpu.dp.engine import PairBatch, device_batch, device_tables  # noqa: E402
from quaff_tpu.dp.scores import ScoreTables  # noqa: E402
from quaff_tpu.io.fastseq import FastSeq, KmerIndex  # noqa: E402
from quaff_tpu.model.params import default_params  # noqa: E402
from quaff_tpu.parallel.estep import sharded_align_scores  # noqa: E402


def test_sharded_align_kernel_matches_chunked():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices (conftest XLA_FLAGS)")

    rng = np.random.default_rng(7)
    params = default_params()
    tables = ScoreTables.from_params(params)
    tdev = device_tables(tables)

    def rand_seq(n):
        return "".join(DNA_ALPHABET[t] for t in rng.integers(0, 4, n))

    refs = [FastSeq(name=f"ref{i}", seq=rand_seq(120)) for i in range(2)]
    reads = []
    for i in range(8):
        src = refs[i % 2].seq[10:90]
        toks = [
            int(rng.integers(0, 4)) if rng.random() < 0.08
            else DNA_ALPHABET.index(c)
            for c in src
        ]
        seq = "".join(DNA_ALPHABET[t] for t in toks)
        qual = "".join(chr(33 + int(q)) for q in rng.integers(5, 30, len(seq)))
        reads.append(FastSeq(name=f"read{i}", seq=seq, qual=qual))

    config = DPConfig(sparse=False)
    W, LP = 128, 128  # uniform chunk shapes across devices

    chunks = []
    for y in reads:
        yi = KmerIndex(y, config.kmer_len)
        pairs = [
            (x, y, config.make_envelope(x, yi, VITERBI_CELL_SIZE))
            for x in refs
        ]
        batch = PairBatch.build_packed(pairs, tables, width=W, max_y_len=LP)
        chunks.append(device_batch(batch))

    stacked = {k: jnp.stack([c[k] for c in chunks]) for k in chunks[0]}

    devices = np.array(jax.devices()[:8]).reshape(8, 1)
    mesh = Mesh(devices, ("dp", "mp"))
    scores = sharded_align_scores(mesh, tdev, stacked, local=True)

    want = np.stack(
        [np.asarray(viterbi_scores(tdev, c, local=True)) for c in chunks]
    )
    got = np.asarray(scores, np.float64)
    assert got.shape == want.shape == (8, len(refs))
    assert np.isfinite(want).any()  # the workload actually aligns
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
