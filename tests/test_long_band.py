"""Automatic long-band fallback (round 4): when a pair's lane-packed
width exceeds the kernel budgets, the envelope is re-banded with the
memory-fitted walk (envelope.fit_envelope_lanes — the reference's
diagenv.cpp:60-106 budget algorithm with the packed-lane cost model) and
the pipelines keep working.  The true seed cluster must survive the
refit, so scores/alignments are unchanged whenever the winning path lies
inside it (it always does on real seed clusters — the dropped diagonals
are spurious threshold-level noise)."""

import numpy as np
import pytest

from quaff_tpu.envelope import fit_envelope_lanes, make_envelope, pack_strips
from quaff_tpu.io.fastseq import FastSeq, KmerIndex
from quaff_tpu.model.params import QuaffNullParams, default_params

BASES = "ACGT"


def _scattered_workload(rng):
    """A read whose envelope has the true cluster plus spurious seed
    clusters far away: the ref embeds the read's source at offset 1200
    AND scatters copies of one read motif at distant offsets, giving
    threshold-passing diagonals across a wide range."""
    src = "".join(BASES[i] for i in rng.integers(0, 4, size=600))
    motif = src[100:160]  # 60-mer => ~50 seed matches on its diagonal
    ref = (
        "".join(BASES[i] for i in rng.integers(0, 4, size=300))
        + motif
        + "".join(BASES[i] for i in rng.integers(0, 4, size=500))
        + motif
        + "".join(BASES[i] for i in rng.integers(0, 4, size=340))
        + src
        + "".join(BASES[i] for i in rng.integers(0, 4, size=300))
    )
    qual = "".join(chr(33 + int(q)) for q in rng.integers(10, 40, size=len(src)))
    return (
        FastSeq(name="ref", seq=ref),
        FastSeq(name="read", seq=src, qual=qual),
    )


def test_fit_envelope_lanes_respects_budget_and_keeps_cluster():
    rng = np.random.default_rng(11)
    ref, read = _scattered_workload(rng)
    yi = KmerIndex(read, 6)
    full = make_envelope(ref, yi, kmer_threshold=10, cell_size=24)
    w_full = sum(s.band_width for s in pack_strips(full))
    # the scattered motif copies force a wide packed band
    assert w_full > 300, w_full

    fitted = fit_envelope_lanes(ref, yi, 250, kmer_threshold=10)
    w_fit = sum(s.band_width for s in pack_strips(fitted))
    assert w_fit <= 250, w_fit
    # diagonal 0 always included (diagenv.cpp:52-54)
    assert 0 in set(fitted.diagonals.tolist())
    # the true cluster (read source at ref offset 1260) survives
    true_diag = 1260
    diags = set(fitted.diagonals.tolist())
    assert any(d in diags for d in range(true_diag - 8, true_diag + 9))

    # even a budget too small for any level keeps the top level
    tiny = fit_envelope_lanes(ref, yi, 1, kmer_threshold=10)
    assert any(
        d in set(tiny.diagonals.tolist())
        for d in range(true_diag - 8, true_diag + 9)
    )


def test_fitted_envelope_same_alignment():
    """The engine on the fitted envelope produces the same winning score
    as on the unfitted one (the winner path lies in the true cluster)."""
    from quaff_tpu.dp.engine import (
        PairBatch,
        device_batch,
        device_tables,
        dp_fill,
    )
    from quaff_tpu.dp.scores import ScoreTables

    rng = np.random.default_rng(12)
    ref, read = _scattered_workload(rng)
    params = default_params()
    tables = ScoreTables.from_params(params)
    yi = KmerIndex(read, 6)
    full = make_envelope(ref, yi, kmer_threshold=10, cell_size=24)
    fitted = fit_envelope_lanes(ref, yi, 250, kmer_threshold=10)

    tdev = device_tables(tables)
    scores = []
    for env in (full, fitted):
        batch = PairBatch.build([(ref, read, env)], tables)
        res = dp_fill(
            tdev, device_batch(batch), mode="viterbi", local=True,
            dtype=np.float64,
        )
        scores.append(float(np.asarray(res["score"])[0]))
    assert scores[0] == scores[1], scores


def test_trainer_long_band_guard_engages(monkeypatch):
    """With a tight lane cap the batched device E-step re-bands wide
    pairs automatically and still produces counts close to the f64
    engine's on the unfitted envelope (the dropped noise diagonals carry
    negligible posterior mass)."""
    from quaff_tpu.aligner import DPConfig
    from quaff_tpu.trainer import QuaffCounter

    rng = np.random.default_rng(13)
    # smaller than the other tests
    src = "".join(BASES[i] for i in rng.integers(0, 4, size=250))
    motif = src[40:100]
    ref_seq = (
        "".join(BASES[i] for i in rng.integers(0, 4, size=150))
        + motif
        + "".join(BASES[i] for i in rng.integers(0, 4, size=400))
        + src
        + "".join(BASES[i] for i in rng.integers(0, 4, size=150))
    )
    qual = "".join(chr(33 + int(q)) for q in rng.integers(10, 40, size=len(src)))
    ref = FastSeq(name="ref", seq=ref_seq)
    read = FastSeq(name="read", seq=src, qual=qual)
    reads = [read, FastSeq(name="r2", seq=src, qual=qual)]
    params = default_params()
    null = QuaffNullParams.fit(reads)
    config = DPConfig(kmer_threshold=10)

    calls = []
    import quaff_tpu.envelope as env_mod

    orig_fit = env_mod.fit_envelope_lanes

    def spy(*a, **k):
        calls.append(a)
        return orig_fit(*a, **k)

    monkeypatch.setattr(env_mod, "fit_envelope_lanes", spy)
    # cap so tight the scattered bounding band must refit
    monkeypatch.setenv("QUAFF_ESTEP_LANE_CAP", "300")

    comp = QuaffCounter(params, null, config)
    monkeypatch.setattr(comp, "_use_device", lambda: True)
    counts_k, ll_k, _ = comp.get_counts([ref], reads, [[0], [0]])
    assert calls, "long-band guard never engaged"

    comp64 = QuaffCounter(params, null, config, prefer_device=False)
    counts_e, ll_e, _ = comp64.get_counts([ref], reads, [[0], [0]])

    assert abs(ll_k - ll_e) < 5e-3 * abs(ll_e) + 5e-3
    a = float(np.sum(counts_k.match))
    b = float(np.sum(counts_e.match))
    assert abs(a - b) < 5e-3 * abs(b) + 5e-3


def test_trainer_oversize_read_falls_back_to_engine(monkeypatch):
    """A read whose band exceeds the lane cap even after the memory-
    fitted refit (cap smaller than the top seed cluster) must route
    through the per-read engine path and produce the engine's exact
    result."""
    from quaff_tpu.aligner import DPConfig
    from quaff_tpu.trainer import QuaffCounter

    rng = np.random.default_rng(14)
    src = "".join(BASES[i] for i in rng.integers(0, 4, size=220))
    ref_seq = (
        "".join(BASES[i] for i in rng.integers(0, 4, size=120))
        + src
        + "".join(BASES[i] for i in rng.integers(0, 4, size=120))
    )
    qual = "".join(chr(33 + int(q)) for q in rng.integers(10, 40, size=len(src)))
    ref = FastSeq(name="ref", seq=ref_seq)
    reads = [
        FastSeq(name="r0", seq=src, qual=qual),
        FastSeq(name="r1", seq=src, qual=qual),
    ]
    params = default_params()
    null = QuaffNullParams.fit(reads)
    config = DPConfig(kmer_threshold=10)

    # cap below any real band width: every read is oversize
    monkeypatch.setenv("QUAFF_ESTEP_LANE_CAP", "8")
    comp = QuaffCounter(params, null, config)
    monkeypatch.setattr(comp, "_use_device", lambda: True)
    # the batched device E-step must never run for an oversize read

    def boom(*a, **k):
        raise AssertionError("batched E-step ran for an oversize read")

    monkeypatch.setattr(comp, "_device_estep", boom)
    counts_k, ll_k, orders_k = comp.get_counts([ref], reads, [[0], [0]])

    comp64 = QuaffCounter(params, null, config, prefer_device=False)
    counts_e, ll_e, orders_e = comp64.get_counts([ref], reads, [[0], [0]])
    assert ll_k == ll_e
    assert orders_k == orders_e
    np.testing.assert_array_equal(counts_k.match, counts_e.match)


def test_overlap_wide_pairs_exact_pass(monkeypatch):
    """Overlap pairs whose band exceeds the lane cap even after refit
    skip device scoring and take the host exact pass, in pair order —
    output identical to the sequential CPU path."""
    import io

    from quaff_tpu.aligner import DPConfig
    from quaff_tpu.formats.alignment import AlignmentPrinter
    from quaff_tpu.io.fastseq import add_revcomps
    from quaff_tpu.overlap import QuaffOverlapAligner

    rng = np.random.default_rng(15)
    base = "".join(BASES[i] for i in rng.integers(0, 4, size=400))
    reads = []
    for i in range(3):
        seq = list(base[i * 40 : i * 40 + 280])
        for _ in range(10):
            p = int(rng.integers(0, len(seq)))
            seq[p] = BASES[int(rng.integers(0, 4))]
        qual = "".join(
            chr(33 + int(q)) for q in rng.integers(10, 40, size=len(seq))
        )
        reads.append(FastSeq(name=f"r{i}", seq="".join(seq), qual=qual))
    params = default_params()
    null = QuaffNullParams.fit(reads)
    config = DPConfig(kmer_threshold=10, threads=1)
    printer = AlignmentPrinter()
    printer.log_odds_threshold = float("-inf")
    seqs = add_revcomps(reads)

    # sequential CPU reference output
    ov = QuaffOverlapAligner(params, null, config)
    out_seq = io.StringIO()
    ov.align_all(out_seq, seqs, len(reads), printer)

    # batched path with every pair forced wide: no device dispatches
    from quaff_tpu.device import DISPATCHES

    monkeypatch.setenv("QUAFF_OVERLAP_LANE_CAP", "2")
    before = DISPATCHES["overlap"]
    ov2 = QuaffOverlapAligner(params, null, config)
    out_b = io.StringIO()
    pair_list = list(ov2.enumerate_pairs(seqs, len(reads)))
    printer.write_header(out_b, seqs, group_by_query=False)
    ov2._align_all_batched(out_b, seqs, pair_list, printer)

    assert DISPATCHES["overlap"] == before
    assert out_b.getvalue() == out_seq.getvalue()
