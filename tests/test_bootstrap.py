"""ssh bootstrap loopback test with a stub ssh.

The reference's -remote path sshes to a host, starts a worker, and waits
for the "# READY" stdout sentinel (execWithRetries, qmodel.cpp:1171-1229).
We exercise the same machinery with a stub ssh that evals the remote
command locally, then delegate real alignment tasks over the launched
worker's socket and demand golden-identical output.
"""

import io
import os
import stat

import pytest

from quaff_tpu.bootstrap import RemoteServerPool, RemoteServerSpec, SshLauncher
from quaff_tpu.formats import AlignmentPrinter, OutputFormat
from quaff_tpu.server import RemoteWorker, remote_align_all


@pytest.fixture
def stub_ssh(tmp_path):
    """A fake ssh: ignores options/host, evals the remote command locally."""
    path = tmp_path / "stub-ssh"
    path.write_text('#!/bin/sh\nfor last; do :; done\neval "$last"\n')
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_ssh_bootstrap_align_golden(data_dir, stub_ssh, monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("QUAFF_TPU_X64", "1")
    import pathlib
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    worker_cmd = f"PYTHONPATH={root} {sys.executable} -m quaff_tpu.cli"
    port = _free_port()
    reads_file = data_dir / "c8f30.fastq.gz"
    server_args = (
        f"align -kmatchband 64 -kmatch 6 -kmatchmb 10 -fwdstrand "
        f"-ref {reads_file} -read {reads_file}"
    )
    pool = RemoteServerPool(
        launcher=SshLauncher(ssh_path=stub_ssh),
        worker_command=worker_cmd,
        max_attempts=2,
        ready_timeout=180.0,
        min_retry_delay=0.5,
    )
    remotes = pool.start(
        [RemoteServerSpec(addr="localhost", port=port)], server_args
    )
    try:
        assert remotes == [("localhost", port)]
        workers = [RemoteWorker(a, p) for a, p in remotes]
        from quaff_tpu.io import read_fast_seqs

        reads = read_fast_seqs(str(reads_file))
        refs = read_fast_seqs(str(reads_file))
        for r in refs:
            r.qual = ""
        out = io.StringIO()
        printer = AlignmentPrinter(format=OutputFormat.STOCKHOLM)
        remote_align_all(out, workers, reads, refs, printer)
        for w in workers:
            w.close()
        assert out.getvalue() == (data_dir / "c8f30-self-align.json").read_text()
    finally:
        pool.stop()
