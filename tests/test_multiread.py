"""Multi-read batched alignment parity.

Three reads (the c8f30 original plus noisy substrings) against three
reference variants exercise the cross-read bucketed batch scoring path
(distinct read-length buckets) — output must be byte-identical to the
reference binary's.
"""

import contextlib
import io

from quaff_tpu.cli import main


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_multiread_batched_align(data_dir):
    rc, out = _run(
        [
            "align",
            str(data_dir / "multiref.fasta"),
            str(data_dir / "multireads.fastq"),
            "-kmatchmb",
            "10",
            "-fwdstrand",
        ]
    )
    assert rc == 0
    assert out == (data_dir / "multireads-align.oracle.txt").read_text()


def test_batched_matches_sequential(data_dir):
    """The bucketed batch path and the per-read path must agree exactly."""
    from quaff_tpu.aligner import DPConfig, QuaffAligner
    from quaff_tpu.formats import AlignmentPrinter
    from quaff_tpu.io import read_fast_seqs
    from quaff_tpu.model import QuaffNullParams, default_params

    reads = read_fast_seqs(str(data_dir / "multireads.fastq"))
    refs = read_fast_seqs(str(data_dir / "multiref.fasta"))
    for r in refs:
        r.qual = ""
    null = QuaffNullParams.fit(reads)
    cfg = DPConfig(kmer_threshold=-1, max_size=10 << 20)
    aligner = QuaffAligner(default_params(), null, cfg)
    printer = AlignmentPrinter()

    batched = io.StringIO()
    aligner.align_all(batched, refs, reads, printer)

    sequential = io.StringIO()
    printer.write_header(sequential, refs, group_by_query=True)
    for y in reads:
        for a in aligner.align_read(refs, y):
            printer.write_alignment(sequential, a)

    assert batched.getvalue() == sequential.getvalue()


def test_wide_envelope_fallback_matches(monkeypatch):
    """Forcing the wide-envelope host-engine fallback (normally only hit
    by pathological merged seed clusters) must not change any output."""
    import io

    import numpy as np

    from quaff_tpu.aligner import DPConfig, QuaffAligner
    from quaff_tpu.formats.alignment import AlignmentPrinter, OutputFormat
    from quaff_tpu.io.fastseq import FastSeq
    from quaff_tpu.logger import ProgressLogger
    from quaff_tpu.model.params import QuaffNullParams, default_params

    rng = np.random.default_rng(5)
    base = "".join("acgt"[t] for t in rng.integers(0, 4, 1200))
    ref = FastSeq(name="ref", seq=base)
    reads = []
    for i in range(3):
        s0 = int(rng.integers(0, 400))
        ln = int(rng.integers(300, 500))
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
    aligner = QuaffAligner(default_params(), null, DPConfig())
    # force the batched path + the fallback branch regardless of backend
    monkeypatch.setattr(QuaffAligner, "_use_fast_scores", lambda self: True)
    monkeypatch.setattr("quaff_tpu.dp.align_kernel.MAX_LANES", 0)
    plog = ProgressLogger(level=99)
    plog.init_progress("test")
    per_read = aligner._align_batched([ref], reads, plog)
    assert set(per_read) == {0, 1, 2}
    # sanity: alignments survive and carry adjusted scores
    for ny, aligns in per_read.items():
        assert aligns and np.isfinite(aligns[0].score)


def test_batched_fast_path_matches_parity(monkeypatch):
    """The device path (kernel phase-B with per-strip scores, strip-
    scoped winner fills, pipelined phase C on a thread pool) must write
    byte-identical output to the CPU parity path.  Reads contain a
    repeated region so envelopes split into multiple strips and the
    near-best strip filter is exercised; two refs exercise winner
    selection; -printall exercises multi-candidate emission order."""
    import io

    import numpy as np

    from quaff_tpu.aligner import DPConfig, QuaffAligner
    from quaff_tpu.formats.alignment import AlignmentPrinter
    from quaff_tpu.io.fastseq import FastSeq
    from quaff_tpu.model.params import QuaffNullParams, default_params

    rng = np.random.default_rng(11)
    core = "".join("acgt"[t] for t in rng.integers(0, 4, 120))
    spacer = "".join("acgt"[t] for t in rng.integers(0, 4, 200))
    # second repeat copy degraded: its strip scores several nats below
    # the first copy's, so the near-best filter DROPS it for some reads
    # (the risky path — output must still match the fill-everything
    # parity run) while other reads keep both
    core2 = list(core)
    for p in range(0, len(core2), 17):
        core2[p] = "acgt"[(("acgt".index(core2[p])) + 1) % 4]
    ref1 = FastSeq(name="refA", seq=core + spacer + "".join(core2))
    ref2 = FastSeq(
        name="refB", seq="".join("acgt"[t] for t in rng.integers(0, 4, 500))
    )
    reads = []
    for i in range(5):
        ys = list(core)
        for p in range(len(ys)):
            if rng.random() < 0.05:
                ys[p] = "acgt"[int(rng.integers(0, 4))]
        reads.append(
            FastSeq(
                name=f"r{i}", seq="".join(ys),
                qual="".join(
                    chr(33 + int(q)) for q in rng.integers(3, 40, len(ys))
                ),
            )
        )
    null = QuaffNullParams.fit(reads)

    for print_all in (False, True):
        cfg = DPConfig(kmer_threshold=5, threads=2)
        aligner = QuaffAligner(
            default_params(), null, cfg, print_all=print_all
        )
        printer = AlignmentPrinter()
        printer.log_odds_threshold = float("-inf")
        parity = io.StringIO()
        aligner.align_all(parity, [ref1, ref2], reads, printer)

        # the device path on the CPU: the align kernel runs in the
        # Pallas interpreter
        monkeypatch.setattr(
            QuaffAligner, "_use_fast_scores", lambda self: True
        )
        aligner2 = QuaffAligner(
            default_params(), null, cfg, print_all=print_all
        )
        fastout = io.StringIO()
        aligner2.align_all(fastout, [ref1, ref2], reads, printer)
        monkeypatch.undo()

        assert fastout.getvalue() == parity.getvalue()
