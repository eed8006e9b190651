"""The capability check (quaff_tpu.device) and the device routes it
selects, run on the CPU: the batch budget, the align / E-step / overlap
device paths (dispatch counts and output against the host f64 routes),
the XLA overlap and E-step scorers against their f64 parity fills, and
the mesh-sharded overlap scorer against the unsharded one."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quaff_tpu import device
from quaff_tpu.aligner import DPConfig, VITERBI_CELL_SIZE
from quaff_tpu.formats.alignment import AlignmentPrinter
from quaff_tpu.io.fastseq import FastSeq, KmerIndex, add_revcomps
from quaff_tpu.model.params import QuaffNullParams, default_params


@pytest.mark.parametrize("backend,expect", [("cpu", False), ("gpu", True)])
def test_device_scorers_follow_the_backend(monkeypatch, backend, expect):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert device.device_scorers() is expect


@pytest.mark.parametrize(
    "limit,per_item,cap,want",
    [
        (80 << 30, 218 << 20, 1024, 128),  # c8f30 E-step pairs on 80 GB
        (80 << 30, 300 << 10, 2048, 2048),  # the work cap binds
        (0, 1, 2048, 8),  # no memory: the smallest batch
    ],
)
def test_batch_items(monkeypatch, limit, per_item, cap, want):
    monkeypatch.setattr(device, "memory_limit_bytes", lambda: limit)
    assert device.batch_items(per_item, cap) == want


def test_warm_flags_follow_dispatches(monkeypatch):
    monkeypatch.setattr(device, "DISPATCHES", type(device.DISPATCHES)())
    assert not device.warm("align")
    device.record_dispatch("align")
    assert device.warm("align") and not device.warm("overlap")


def _reads(rng, n, length, src):
    out = []
    for i in range(n):
        s0 = int(rng.integers(0, len(src) - length))
        seq = list(src[s0 : s0 + length])
        for p in range(len(seq)):
            if rng.random() < 0.04:
                seq[p] = "ACGT"[int(rng.integers(0, 4))]
        qual = "".join(chr(33 + int(q)) for q in rng.integers(5, 40, length))
        out.append(FastSeq(name=f"r{i}", seq="".join(seq), qual=qual))
    return out


def test_align_device_route_matches_host(monkeypatch):
    from quaff_tpu.aligner import QuaffAligner

    rng = np.random.default_rng(31)
    src = "".join("ACGT"[t] for t in rng.integers(0, 4, 700))
    ref = FastSeq(name="ref", seq=src)
    reads = _reads(rng, 4, 250, src)
    null = QuaffNullParams.fit(reads)
    printer = AlignmentPrinter()
    printer.log_odds_threshold = float("-inf")
    cfg = DPConfig(kmer_threshold=5)
    host = io.StringIO()
    QuaffAligner(default_params(), null, cfg).align_all(host, [ref], reads, printer)

    # the route, not the backend: the kernel stays in the interpreter here
    monkeypatch.setattr(QuaffAligner, "_use_fast_scores", lambda self: True)
    before = device.DISPATCHES["align"]
    dev = io.StringIO()
    QuaffAligner(default_params(), null, cfg).align_all(dev, [ref], reads, printer)
    assert device.DISPATCHES["align"] > before
    assert dev.getvalue() == host.getvalue()


def test_estep_device_route_matches_host(monkeypatch):
    from quaff_tpu.trainer import QuaffCounter

    rng = np.random.default_rng(32)
    src = "".join("ACGT"[t] for t in rng.integers(0, 4, 500))
    ref = FastSeq(name="ref", seq=src)
    reads = _reads(rng, 3, 200, src)
    null = QuaffNullParams.fit(reads)
    host = QuaffCounter(default_params(), null, DPConfig(kmer_threshold=5),
                        prefer_device=False)
    c64, ll64, o64 = host.get_counts([ref], reads)

    monkeypatch.setattr(QuaffCounter, "_use_device", lambda self: self.prefer_device)
    before = device.DISPATCHES["estep"]
    dev = QuaffCounter(default_params(), null,
                       DPConfig(kmer_threshold=5, dtype=jnp.float32))
    c32, ll32, o32 = dev.get_counts([ref], reads)
    assert device.DISPATCHES["estep"] > before
    assert o32 == o64
    assert abs(ll32 - ll64) <= 5e-3 + 5e-3 * abs(ll64)
    np.testing.assert_array_less(
        np.abs(c32.match - c64.match), 5e-3 + 5e-3 * np.abs(c64.match)
    )


@pytest.mark.parametrize("threshold", [float("-inf"), 0.0])
def test_overlap_device_route_matches_sequential(monkeypatch, threshold):
    """Device strip scores + exact pass write the sequential host
    output; with a finite threshold every multi-strip or single-strip
    pair is scored on the device first."""
    from quaff_tpu.overlap import QuaffOverlapAligner

    rng = np.random.default_rng(33)
    src = "".join("ACGT"[t] for t in rng.integers(0, 4, 900))
    reads = _reads(rng, 4, 300, src)
    null = QuaffNullParams.fit(reads)
    seqs = add_revcomps(reads)
    cfg = DPConfig(kmer_threshold=10, threads=2)
    printer = AlignmentPrinter()
    printer.log_odds_threshold = threshold
    seq_out = io.StringIO()
    QuaffOverlapAligner(default_params(), null, cfg).align_all(
        seq_out, seqs, len(reads), printer
    )

    monkeypatch.setattr(QuaffOverlapAligner, "_use_fast_scores", lambda self: True)
    before = device.DISPATCHES["overlap"]
    dev_out = io.StringIO()
    QuaffOverlapAligner(default_params(), null, cfg).align_all(
        dev_out, seqs, len(reads), printer
    )
    if threshold > float("-inf"):
        assert device.DISPATCHES["overlap"] > before
    assert dev_out.getvalue() == seq_out.getvalue()


@pytest.mark.parametrize("y_comp", [False, True])
@pytest.mark.parametrize("with_qual", [True, False])
def test_overlap_strip_scores_match_f64(y_comp, with_qual):
    """overlap_fill in f32, score-only, over row-trimmed envelope strips
    (the device route's batches) against the f64 fill of the same
    strips."""
    from quaff_tpu.dp.overlap import (
        OverlapScoreTables,
        overlap_device_tables,
        overlap_fill,
    )
    from quaff_tpu.envelope import pack_strips, sparse_envelope
    from quaff_tpu.overlap import OverlapBatch

    rng = np.random.default_rng(34)
    src = "".join("ACGT"[t] for t in rng.integers(0, 4, 800))
    reads = _reads(rng, 4, 300, src)
    if not with_qual:
        for r in reads:
            r.qual = ""
    tables = OverlapScoreTables.from_params(default_params(), y_comp)
    entries, offs = [], []
    for a in reads:
        for b in reads:
            if a is b:
                continue
            env = sparse_envelope(a, KmerIndex(b, 6), band_size=32,
                                  kmer_threshold=6)
            for s in pack_strips(env):
                d1 = int(s.diagonals[-1])
                entries.append((a, b, s))
                offs.append(max(1, 1 - d1) - 1)
    rows = max(len(r.seq) for r in reads)
    ob = OverlapBatch(entries, tables, row_off=offs, n_rows=rows)
    tdev = overlap_device_tables(tables)
    got = np.asarray(
        overlap_fill(tdev, ob.device(), dtype=jnp.float32)["score"], np.float64
    )
    want = np.asarray(
        overlap_fill(tdev, ob.device(), dtype=jnp.float64)["score"]
    )
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert fin.any()
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=0.05)


def test_estep_keyed_counts_hold_one_unit_per_base():
    """dp_forward_backward's keyed count reductions (segment sums by
    k-mer and quality) place one unit of match + insert mass per read
    base, under the read's own quality keys."""
    from quaff_tpu.dp.counts import dp_forward_backward
    from quaff_tpu.dp.engine import PairBatch, device_batch, device_tables
    from quaff_tpu.dp.scores import ScoreTables
    from quaff_tpu.envelope import full_envelope

    rng = np.random.default_rng(35)
    src = "".join("ACGT"[t] for t in rng.integers(0, 4, 90))
    reads = _reads(rng, 2, 60, src)
    x = FastSeq(name="x", seq=src)
    tables = ScoreTables.from_params(default_params())
    pairs = [(x, y, full_envelope(len(src), len(y.seq))) for y in reads]
    batch = PairBatch.build(pairs, tables)
    res = dp_forward_backward(
        device_tables(tables), device_batch(batch), local=True,
        dtype=jnp.float64, num_match_kmers=4, num_indel_kmers=1,
    )
    # every read position is emitted by exactly one state: the posterior
    # mass of match + insert over the band sums to one per row, so the
    # match and insert counts together hold one unit per read base
    for b, (_, y, _) in enumerate(pairs):
        total = float(np.sum(res["match_counts"][b]) + np.sum(res["insert_counts"][b]))
        np.testing.assert_allclose(total, len(y.seq), rtol=1e-6)
        # the quality key of each count is the read's own quality
        q_seen = set(np.nonzero(np.asarray(res["insert_counts"][b]).sum(0)
                                + np.asarray(res["match_counts"][b]).sum((0, 1)))[0])
        assert q_seen <= set(y.qual_scores().tolist())


def test_sharded_overlap_scores_match_unsharded():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices (conftest XLA_FLAGS)")
    from jax.sharding import Mesh

    from quaff_tpu.dp.overlap import (
        OverlapScoreTables,
        overlap_device_tables,
        overlap_fill,
    )
    from quaff_tpu.overlap import OverlapBatch
    from quaff_tpu.parallel import estep
    from quaff_tpu.parallel.estep import sharded_overlap_scores

    rng = np.random.default_rng(36)
    src = "".join("ACGT"[t] for t in rng.integers(0, 4, 400))
    reads = _reads(rng, 9, 120, src)
    cfg = DPConfig(kmer_threshold=4)
    tables = OverlapScoreTables.from_params(default_params(), False)
    tdev = overlap_device_tables(tables)
    chunks = []
    for d in range(8):
        a, b = reads[d], reads[d + 1]
        env = cfg.make_envelope(a, KmerIndex(b, cfg.kmer_len), VITERBI_CELL_SIZE)
        chunks.append(
            OverlapBatch([(a, b, env)] * 2, tables, width=256, max_y_len=128,
                         max_x_len=128).device()
        )
    stacked = {k: jnp.stack([c[k] for c in chunks]) for k in chunks[0]}
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8, 1), ("dp", "mp"))
    got = np.asarray(sharded_overlap_scores(mesh, tdev, stacked))
    want = np.stack([
        np.asarray(overlap_fill(tdev, c, dtype=jnp.float32)["score"])
        for c in chunks
    ])
    assert got.shape == (8, 2)
    np.testing.assert_array_equal(got, want)
    # a second call (new values, same shapes) reuses the compiled program
    again = np.asarray(sharded_overlap_scores(mesh, tdev, stacked))
    np.testing.assert_array_equal(again, want)
    step = estep._chunk_program(
        mesh, tuple(sorted(stacked)), estep._overlap_scores, ()
    )
    assert step._cache_size() == 1


@pytest.mark.gpu
def test_estep_on_gpu(gpu):
    """The batched E-step on the card against the f64 per-read route."""
    from quaff_tpu.trainer import QuaffCounter

    rng = np.random.default_rng(37)
    src = "".join("ACGT"[t] for t in rng.integers(0, 4, 1500))
    ref = FastSeq(name="ref", seq=src)
    reads = _reads(rng, 6, 1200, src)
    null = QuaffNullParams.fit(reads)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        c64, ll64, _ = QuaffCounter(
            default_params(), null, DPConfig(), prefer_device=False
        ).get_counts([ref], reads)
    c32, ll32, _ = QuaffCounter(
        default_params(), null, DPConfig(dtype=jnp.float32)
    ).get_counts([ref], reads)
    assert abs(ll32 - ll64) <= 5e-3 + 5e-3 * abs(ll64)
    np.testing.assert_array_less(
        np.abs(c32.match - c64.match), 5e-3 + 5e-3 * np.abs(c64.match)
    )


@pytest.mark.gpu
def test_overlap_scores_on_gpu(gpu):
    """overlap_fill, f32 score-only on the card, against its f64 fill on
    the CPU device."""
    from quaff_tpu.dp.overlap import (
        OverlapScoreTables,
        overlap_device_tables,
        overlap_fill,
    )
    from quaff_tpu.envelope import pack_strips, sparse_envelope
    from quaff_tpu.overlap import OverlapBatch

    rng = np.random.default_rng(38)
    src = "".join("ACGT"[t] for t in rng.integers(0, 4, 2000))
    reads = _reads(rng, 4, 1500, src)
    tables = OverlapScoreTables.from_params(default_params(), False)
    entries = [
        (a, b, s)
        for a in reads for b in reads if a is not b
        for s in pack_strips(
            sparse_envelope(a, KmerIndex(b, 6), band_size=32, kmer_threshold=6)
        )
    ]
    ob = OverlapBatch(entries, tables)
    got = np.asarray(
        overlap_fill(overlap_device_tables(tables), ob.device(),
                     dtype=jnp.float32)["score"], np.float64,
    )
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        want = np.asarray(
            overlap_fill(overlap_device_tables(tables), ob.device(),
                         dtype=jnp.float64)["score"]
        )
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=0.01)
