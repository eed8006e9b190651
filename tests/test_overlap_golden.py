"""Overlap golden test, mirroring the reference integration test
(Makefile:153-156):
  quaff overlap data/c8f30.fastq.gz data/copy-of-c8f30.fastq -kmatchmb 10 -fwdstrand
must reproduce data/c8f30-self-overlap.json byte for byte (score 6876.76;
requires the reference's truncated log-sum-exp semantics in the pair
table build).
"""

import gzip
import io

import pytest

from quaff_tpu.aligner import DPConfig
from quaff_tpu.formats import AlignmentPrinter, OutputFormat
from quaff_tpu.io import read_fast_seqs
from quaff_tpu.model import QuaffNullParams, default_params
from quaff_tpu.overlap import QuaffOverlapAligner


@pytest.fixture(scope="module")
def copy_file(tmp_path_factory):
    import pathlib

    data = pathlib.Path(__file__).parent / "data"
    path = data / "copy-of-c8f30.fastq"
    if not path.exists():
        text = gzip.open(data / "c8f30.fastq.gz", "rt").read()
        path.write_text(text.replace("channel", "copy"))
    return path


def test_c8f30_self_overlap_golden(data_dir, copy_file):
    seqs = read_fast_seqs(str(data_dir / "c8f30.fastq.gz")) + read_fast_seqs(
        str(copy_file)
    )
    n_originals = 2  # -fwdstrand
    null = QuaffNullParams.fit(seqs)
    cfg = DPConfig(kmer_threshold=-1, max_size=10 << 20)
    aligner = QuaffOverlapAligner(default_params(), null, cfg)
    out = io.StringIO()
    aligner.align_all(
        out, seqs, n_originals, AlignmentPrinter(format=OutputFormat.STOCKHOLM)
    )
    assert out.getvalue() == (data_dir / "c8f30-self-overlap.json").read_text()


def test_batched_exact_pass_matches_per_pair():
    """The batched path's bucketed exact pass (padded, multi-pair fills) must
    produce byte-identical alignments to the sequential per-pair path —
    padding lanes/rows sit outside the envelope so the banded fill and
    the traceback never read them."""
    import numpy as np

    from quaff_tpu.io.fastseq import FastSeq, KmerIndex
    from quaff_tpu.overlap import OverlapBatch
    import io as _io

    from quaff_tpu.aligner import VITERBI_CELL_SIZE

    def format_alignment(a):
        s = _io.StringIO()
        a.write_stockholm(s)
        return s.getvalue()

    rng = np.random.default_rng(7)
    base = "".join("acgt"[t] for t in rng.integers(0, 4, 2000))
    reads = []
    for i in range(4):
        ln = int(rng.integers(400, 600))
        # spread start offsets so shared segments sit on diagonals far
        # from the always-included diagonal 0 -> multi-strip envelopes
        s0 = int(rng.integers(0, 1200))
        seq = list(base[s0 : s0 + ln])
        for _ in range(len(seq) // 20):
            p = int(rng.integers(0, len(seq)))
            seq[p] = "acgt"[int(rng.integers(0, 4))]
        reads.append(
            FastSeq(
                name=f"r{i}",
                seq="".join(seq),
                qual="".join(
                    chr(33 + int(q)) for q in rng.integers(3, 40, ln)
                ),
            )
        )
    null = QuaffNullParams.fit(reads)
    cfg = DPConfig()
    aligner = QuaffOverlapAligner(default_params(), null, cfg)

    jobs = []
    for nx, ny, y_comp in aligner.enumerate_pairs(reads, len(reads)):
        x, y = reads[nx], reads[ny]
        env = cfg.make_envelope(x, KmerIndex(y, cfg.kmer_len), VITERBI_CELL_SIZE)
        jobs.append((nx, ny, y_comp, env))

    # sequential reference results (full bounding-band fills)
    want = [
        aligner.overlap_pair(reads[nx], reads[ny], yc)
        for nx, ny, yc, _ in jobs
    ]

    # multi-strip envelopes must be exercised (diagonal 0 is always a
    # member, and these overlaps sit on distant diagonals)
    assert any(len(env.strips()) > 1 for *_, env in jobs)

    # the production exact pass: per-strip batched fills
    results = aligner._exact_pass(reads, jobs)
    got = [results[(nx, ny)] for nx, ny, _, _ in jobs]

    assert len(want) == len(got)
    for a, b in zip(want, got):
        if a is None or b is None:
            assert a is None and b is None
            continue
        assert a.score == b.score
        assert format_alignment(a) == format_alignment(b)

    # seg-score strip filtering (the device's per-strip scores in
    # production) must not change any output: build the per-strip scores
    # from exact fills and re-run the pass with the filter active
    from quaff_tpu.dp.overlap import overlap_device_tables, overlap_fill
    from quaff_tpu.envelope import pack_strips
    from quaff_tpu.overlap import OverlapBatch
    import jax.numpy as jnp

    seg_scores = {}
    for nx, ny, yc, env in jobs:
        tables = aligner._tables(yc)[0]
        tdev = aligner._tdev(yc)  # engine device tables build lazily
        segs = pack_strips(env, 3)
        sm = np.full(3, -np.inf)
        for k, s in enumerate(segs):
            sm[k] = float(
                np.asarray(
                    overlap_fill(
                        tdev,
                        OverlapBatch([(reads[nx], reads[ny], s)], tables).device(),
                        return_matrices=False, dtype=jnp.float64,
                    )["end"]
                )[0]
            )
        seg_scores[(nx, ny)] = sm
    assert any(
        np.sum(np.isfinite(sm) & (sm < np.max(sm) - 1.0)) > 0
        for sm in seg_scores.values()
    ), "need at least one prunable strip for the filter to bite"
    results2 = aligner._exact_pass(reads, jobs, seg_scores=seg_scores)
    for nx, ny, _, _ in jobs:
        a, b = results[(nx, ny)], results2[(nx, ny)]
        if a is None or b is None:
            assert a is None and b is None
            continue
        assert a.score == b.score
        assert format_alignment(a) == format_alignment(b)


def test_overlap_pair_enumeration():
    from quaff_tpu.io.fastseq import FastSeq

    cfg = DPConfig()
    aligner = QuaffOverlapAligner.__new__(QuaffOverlapAligner)
    seqs = [FastSeq(name=str(i), seq="ACGT") for i in range(4)]
    # 2 originals + 2 revcomp copies: reference order stops at nx+1 >= 2
    pairs = list(aligner.enumerate_pairs(seqs, 2))
    assert pairs == [(0, 1, False), (0, 2, True), (0, 3, True)]
    # fwdstrand, 2 originals only
    pairs = list(aligner.enumerate_pairs(seqs[:2], 2))
    assert pairs == [(0, 1, False)]


def test_ref_lse_chain_native_matches_numpy():
    """The C ordered truncated-lse chain is bit-identical to the numpy
    per-step loop (same float op order; golden overlap scores depend on
    the truncation semantics)."""
    import numpy as np
    import pytest

    from quaff_tpu import native
    from quaff_tpu.dp.overlap import _ref_lse

    if not native.available() or not hasattr(
        native.get_lib(), "qref_lse_chain"
    ):
        pytest.skip("native library not built")

    rng = np.random.default_rng(3)
    terms = rng.normal(-5, 8, size=(200, 7, 13))
    # sprinkle -inf and near-10-nat gaps to hit the truncation branches
    terms[rng.random(terms.shape) < 0.1] = -np.inf
    terms[0] = -np.inf
    acc_c = np.full((7, 13), -np.inf)
    assert native.ref_lse_chain_native(acc_c, terms)
    acc_py = np.full((7, 13), -np.inf)
    for t in range(terms.shape[0]):
        acc_py = _ref_lse(acc_py, terms[t])
    assert np.array_equal(acc_c, acc_py)


def test_exact_pass_matrix_fallback_matches_path(monkeypatch):
    """Both _exact_pass branches (matrix-free checkpointed path vs the
    bucketed stored-matrix fallback used when the native path symbol is
    missing) must stay byte-identical."""
    import io as _io

    import numpy as np

    from quaff_tpu.io.fastseq import FastSeq, KmerIndex
    from quaff_tpu.aligner import VITERBI_CELL_SIZE

    def format_alignment(a):
        s = _io.StringIO()
        a.write_stockholm(s)
        return s.getvalue()

    rng = np.random.default_rng(11)
    base = "".join("acgt"[t] for t in rng.integers(0, 4, 1500))
    reads = []
    for i in range(3):
        ln = int(rng.integers(300, 500))
        s0 = int(rng.integers(0, 900))
        seq = list(base[s0 : s0 + ln])
        for _ in range(len(seq) // 20):
            p = int(rng.integers(0, len(seq)))
            seq[p] = "acgt"[int(rng.integers(0, 4))]
        reads.append(
            FastSeq(
                name=f"r{i}", seq="".join(seq),
                qual="".join(
                    chr(33 + int(q)) for q in rng.integers(3, 40, ln)
                ),
            )
        )
    null = QuaffNullParams.fit(reads)
    cfg = DPConfig()
    aligner = QuaffOverlapAligner(default_params(), null, cfg)
    jobs = []
    for nx, ny, y_comp in aligner.enumerate_pairs(reads, len(reads)):
        env = cfg.make_envelope(
            reads[nx], KmerIndex(reads[ny], cfg.kmer_len), VITERBI_CELL_SIZE
        )
        jobs.append((nx, ny, y_comp, env))

    got_path = aligner._exact_pass(reads, jobs)

    import quaff_tpu.native as qn

    monkeypatch.setattr(qn, "overlap_path_available", lambda: False)
    got_matrix = aligner._exact_pass(reads, jobs)

    assert got_path.keys() == got_matrix.keys()
    for key in got_path:
        a, b = got_path[key], got_matrix[key]
        if a is None or b is None:
            assert a is None and b is None
            continue
        assert a.score == b.score
        assert format_alignment(a) == format_alignment(b)
