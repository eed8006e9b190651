"""CLI `-mesh` align/overlap: sharded batch scoring over the device mesh
must leave the output byte-identical to the sequential pipelines (the
mesh analogue of the reference's parallelized align/overlap,
qmodel.cpp:2624-2646 / qoverlap.cpp:312-334 — every workload is
parallelized, not just training)."""

import contextlib
import io
import pathlib

import pytest

jax = pytest.importorskip("jax")

from quaff_tpu.cli import main  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.fixture(autouse=True)
def _need_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices (conftest XLA_FLAGS)")


def test_mesh_align_matches_sequential():
    base = [
        "align", str(DATA / "synth12-genome.fasta"),
        str(DATA / "synth12.fastq"), "-kmatchn", "10", "-nothreshold",
    ]
    rc, seq = _run(base)
    assert rc == 0
    rc, mesh = _run(base + ["-mesh"])
    assert rc == 0
    assert mesh == seq
    # and both match the reference oracle
    assert seq == (DATA / "synth12-align.oracle.stk").read_text()


def test_mesh_align_printall_sam():
    base = [
        "align", str(DATA / "multiref.fasta"),
        str(DATA / "multireads.fastq"), "-kmatchn", "1", "-nothreshold",
        "-printall", "-format", "sam",
    ]
    rc, seq = _run(base)
    assert rc == 0
    rc, mesh = _run(base + ["-mesh"])
    assert rc == 0
    assert mesh == seq


def test_mesh_align_multichunk_mixed_ref_lengths(tmp_path, monkeypatch):
    """Regression: chunks within one mesh dispatch group must stack even
    when they contain references of different lengths (the ref-axis
    padding is pinned to the global max).  A zero device memory budget
    forces the chunker to emit several small chunks per group."""
    import numpy as np

    from quaff_tpu.alphabet import DNA_ALPHABET

    monkeypatch.setattr("quaff_tpu.device.memory_limit_bytes", lambda: 0)
    rng = np.random.default_rng(5)
    refs = []
    for i, n in enumerate((80, 200, 140)):  # mixed ref lengths
        refs.append(
            f">ref{i}\n"
            + "".join(DNA_ALPHABET[t] for t in rng.integers(0, 4, n))
            + "\n"
        )
    (tmp_path / "refs.fasta").write_text("".join(refs))
    lines = []
    for i in range(6):
        seq = "".join(DNA_ALPHABET[t] for t in rng.integers(0, 4, 70))
        qual = "".join(chr(33 + int(q)) for q in rng.integers(5, 30, 70))
        lines.append(f"@r{i}\n{seq}\n+\n{qual}\n")
    (tmp_path / "reads.fastq").write_text("".join(lines))
    base = [
        "align", str(tmp_path / "refs.fasta"), str(tmp_path / "reads.fastq"),
        "-kmatchn", "1", "-nothreshold", "-printall",
    ]
    rc, seq_out = _run(base)
    assert rc == 0
    rc, mesh_out = _run(base + ["-mesh"])
    assert rc == 0
    assert mesh_out == seq_out


def test_mesh_align_global_mode():
    # -global changes the recursion's start/end constraints; the mesh
    # scorer must carry the flag through shard_map
    base = [
        "align", str(DATA / "multiref.fasta"),
        str(DATA / "multireads.fastq"), "-kmatchn", "1", "-nothreshold",
        "-global",
    ]
    rc, seq = _run(base)
    assert rc == 0
    rc, mesh = _run(base + ["-mesh"])
    assert rc == 0
    assert mesh == seq


def test_mesh_overlap_matches_sequential():
    base = [
        "overlap", str(DATA / "synth12.fastq"),
        "-kmatchn", "10", "-nothreshold",
    ]
    rc, seq = _run(base)
    assert rc == 0
    rc, mesh = _run(base + ["-mesh"])
    assert rc == 0
    assert mesh == seq
    # the oracle was generated with these exact flags (see
    # test_oracle_goldens.test_overlap_synth12_all_vs_all)
    assert seq == (DATA / "synth12-overlap.oracle.stk").read_text()


def test_mesh_overlap_with_threshold():
    # the kernel-score pruning path (threshold > -inf) under the mesh
    base = ["overlap", str(DATA / "synth12.fastq"), "-kmatchn", "10"]
    rc, seq = _run(base)
    assert rc == 0
    rc, mesh = _run(base + ["-mesh"])
    assert rc == 0
    assert mesh == seq


def test_mesh_align_wide_band_sp_fill(monkeypatch):
    """A pair wider than the align kernel's widest block on a -mesh run scores via
    the band-sharded sp fill (parallel/spfill, SURVEY §5.7) — wired in
    round 4; output must stay byte-identical to the sequential path."""
    import quaff_tpu.aligner as amod
    import quaff_tpu.parallel.spfill as spmod

    base = [
        "align", str(DATA / "synth12-genome.fasta"),
        str(DATA / "synth12.fastq"), "-kmatchn", "10", "-nothreshold",
    ]
    rc, seq = _run(base)
    assert rc == 0

    # every envelope counts as "wide": the kernel path is forbidden and
    # all scoring must go through sp_fill_scores
    monkeypatch.setattr("quaff_tpu.dp.align_kernel.MAX_LANES", 1)
    calls = []
    orig = spmod.sp_fill_scores

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(spmod, "sp_fill_scores", spy)
    # CPU backend: kernels interpret; force the fast path so the batched
    # scorer (and its wide branch) runs at all
    monkeypatch.setattr(
        amod.QuaffAligner, "_use_fast_scores", lambda self: True
    )
    rc, mesh = _run(base + ["-mesh"])
    assert rc == 0
    assert calls, "sp fill never engaged for wide pairs"
    assert mesh == seq
