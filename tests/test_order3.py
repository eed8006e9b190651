"""Order-3 match-context coverage (SURVEY 'hard parts' order-k blowup:
Km = 4^(k+1) = 256 match distributions at -suborder 3 — the split
emission tables grow to [256, 4*128] per qual channel).

Oracles generated with the reference binary (tools/oracle/build_ref.sh):
  quaff train synth12-genome.fasta synth12.fastq -kmatchn 10 -fwdstrand
        -force -maxiter 2 -suborder 3    -> synth12-train-order3.oracle.json
  quaff align synth12-genome.fasta synth12.fastq -kmatchn 10 -nothreshold
        -params <that json>              -> synth12-align-order3.oracle.stk

These pin the CPU parity path and the mesh plumbing at Km=256.

refBase is excluded from the train comparison (reference UB, see
test_train_golden.py).
"""

import json

from test_cli import _run


def test_train_order3_matches_oracle(data_dir):
    rc, out = _run(
        [
            "train",
            str(data_dir / "synth12-genome.fasta"),
            str(data_dir / "synth12.fastq"),
            "-kmatchn", "10", "-fwdstrand", "-force",
            "-maxiter", "2", "-suborder", "3",
        ]
    )
    assert rc == 0
    mine = json.loads(out)
    want = json.loads(
        (data_dir / "synth12-train-order3.oracle.json").read_text()
    )
    assert mine["matchOrder"] == want["matchOrder"] == 4

    mismatches = []

    def cmp(a, b, path=""):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                cmp(a[k], b[k], path + "/" + k)
        elif isinstance(a, (int, float)):
            if path.startswith("/refBase"):
                return  # reference UB (uninitialised totalLen)
            if abs(float(a) - float(b)) > 1e-4 + 2e-3 * abs(float(b)):
                mismatches.append((path, a, b))

    cmp(mine, want)
    assert mismatches == []


def test_align_order3_matches_oracle(data_dir):
    rc, out = _run(
        [
            "align",
            str(data_dir / "synth12-genome.fasta"),
            str(data_dir / "synth12.fastq"),
            "-kmatchn", "10", "-nothreshold",
            "-params", str(data_dir / "synth12-train-order3.oracle.json"),
        ]
    )
    assert rc == 0
    assert out == (data_dir / "synth12-align-order3.oracle.stk").read_text()


def test_mesh_align_order3_matches_oracle(data_dir):
    import jax
    import pytest

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    rc, out = _run(
        [
            "align",
            str(data_dir / "synth12-genome.fasta"),
            str(data_dir / "synth12.fastq"),
            "-kmatchn", "10", "-nothreshold", "-mesh",
            "-params", str(data_dir / "synth12-train-order3.oracle.json"),
        ]
    )
    assert rc == 0
    assert out == (data_dir / "synth12-align-order3.oracle.stk").read_text()
