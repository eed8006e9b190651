"""qsub/NFS batch backend test — the reference's zero-cluster trick
(Makefile:172-176): substituting /bin/sh for qsub makes submission a
synchronous local run of the generated job script, exercising the whole
script-generation / info.json / result-file / done-sentinel machinery.
The output must be byte-identical to the single-process golden.

Each job is a fresh CLI subprocess, so this also covers the single-shot
`server ... -job` path and -readindex single-read loading end to end.
"""

import contextlib
import io
import os

import pytest

from quaff_tpu.cli import main


@pytest.fixture(autouse=True)
def _worker_env(monkeypatch):
    # job subprocesses must compute in f64 on CPU for golden parity
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("QUAFF_TPU_X64", "1")


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.slow
def test_qsub_align_golden(data_dir, tmp_path):
    rc, out = _run(
        [
            "align",
            str(data_dir / "c8f30.fastq.gz"),
            str(data_dir / "c8f30.fastq.gz"),
            "-kmatchmb",
            "10",
            "-fwdstrand",
            "-qsubjobs",
            "1",
            "-qsubpath",
            "/bin/sh",
            "-qsubdir",
            str(tmp_path),
        ]
    )
    assert rc == 0
    assert out == (data_dir / "c8f30-self-align.json").read_text()
    # the job artefacts exist on the "shared filesystem"
    job_dir = tmp_path / "job1"
    assert (job_dir / "job.sh").exists()
    assert (job_dir / "info.json").exists()
    assert (job_dir / "done").exists()
    assert (job_dir / "result").exists()
