"""End-to-end ssh worker bootstrap through the CLI.

`-remote user@host:port` ssh-launches a worker server and dispatches
tasks to it (startRemoteServers + remoteRunQuaffAlignmentTasks,
qmodel.cpp:1093-1125, 2884-2929).  A stub ssh executes the worker
command locally, so the full chain — server-args serialisation, READY
handshake, framed TCP tasks, {"quit":1} shutdown — runs in-process.
"""

import contextlib
import io
import socket

import pytest

from quaff_tpu.cli import main


@pytest.fixture(autouse=True)
def _worker_env(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("QUAFF_TPU_X64", "1")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stub_ssh(tmp_path) -> str:
    stub = tmp_path / "fake-ssh"
    stub.write_text(
        "#!/bin/sh\n"
        "# stand-in for ssh: run the final argument (the remote command)\n"
        "# locally, ignoring the connection options before it\n"
        "for last; do :; done\n"
        'exec sh -c "$last"\n'
    )
    stub.chmod(0o755)
    return str(stub)


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_align_via_ssh_launched_worker(data_dir, tmp_path):
    base = [
        "align",
        str(data_dir / "c8f30.fastq.gz"),
        str(data_dir / "c8f30.fastq.gz"),
        "-kmatchmb",
        "10",
        "-fwdstrand",
    ]
    rc, want = _run(base)
    assert rc == 0 and want

    port = _free_port()
    rc, got = _run(
        base
        + [
            "-remote",
            f"tester@127.0.0.1:{port}",
            "-sshpath",
            _stub_ssh(tmp_path),
        ]
    )
    assert rc == 0
    assert got == want


def test_remote_user_parsing_populates_jobs():
    from collections import deque

    from quaff_tpu.aligner import DPConfig
    from quaff_tpu.cli import _parse_dp_config

    config = DPConfig()
    args = deque(["-remote", "alice@node1:8000-8003", "-remote", "node2:9000"])
    assert _parse_dp_config(args, config)
    assert _parse_dp_config(args, config)
    assert config.remote_jobs == [("alice", "node1", 8000, 4)]
    assert config.remotes == [("node2", 9000)]


def test_server_args_staging_rewrite():
    from quaff_tpu.aligner import DPConfig
    from quaff_tpu.bootstrap import SYNC_STAGING_DIR
    from quaff_tpu.cli import _server_args

    config = DPConfig(use_rsync=True)
    sargs = _server_args(
        "align", config, {"params_file": "/data/p.json"},
        ref_files=["/data/refs.fasta"], read_files=["/data/reads.fastq"],
    )
    assert f"-params {SYNC_STAGING_DIR}/p.json" in sargs
    assert f"-ref {SYNC_STAGING_DIR}/refs.fasta" in sargs
    assert f"-read {SYNC_STAGING_DIR}/reads.fastq" in sargs

    config = DPConfig(bucket="mybucket")
    sargs = _server_args("align", config, {}, ref_files=["/data/refs.fasta"])
    assert "-s3bucket mybucket" in sargs
    assert f"-ref {SYNC_STAGING_DIR}/refs.fasta" in sargs


def test_align_with_rsync_staging(data_dir, tmp_path):
    """-rsync stages data files into the worker staging dir and rewrites
    the worker's file args to the staged paths (makeServerArgs +
    syncToRemote, qmodel.cpp:1019-1085)."""
    import shutil

    from quaff_tpu.bootstrap import SYNC_STAGING_DIR

    # data lives somewhere the worker's rewritten args can't accidentally
    # resolve unless staging actually happened
    src_dir = tmp_path / "cl"
    src_dir.mkdir()
    for fn in ("dpm_ref.fasta", "dpm_read.fastq"):
        shutil.copy(data_dir / fn, src_dir / fn)
    staged = [
        f"{SYNC_STAGING_DIR}/dpm_ref.fasta",
        f"{SYNC_STAGING_DIR}/dpm_read.fastq",
    ]
    import os

    for fn in staged:
        if os.path.exists(fn):
            os.unlink(fn)

    rsync = tmp_path / "fake-rsync"
    rsync.write_text(
        "#!/bin/sh\n"
        "# stand-in for rsync src host:dest — local copy, host prefix cut\n"
        'src="$(eval echo \\${$(($#-1))})"\n'
        'dst="$(eval echo \\${$#})"\n'
        'exec cp "$src" "${dst#*:}"\n'
    )
    rsync.chmod(0o755)

    base = [
        "align",
        str(src_dir / "dpm_ref.fasta"),
        str(src_dir / "dpm_read.fastq"),
        "-kmatchoff",
        "-fwdstrand",
        "-nothreshold",
    ]
    rc, want = _run(base)
    assert rc == 0 and want

    port = _free_port()
    rc, got = _run(
        base
        + [
            "-remote",
            f"tester@127.0.0.1:{port}",
            "-sshpath",
            _stub_ssh(tmp_path),
            "-rsyncpath",
            str(rsync),
            "-rsync",
        ]
    )
    assert rc == 0
    assert got == want
    # files really went through the staging dir
    for fn in staged:
        assert os.path.exists(fn)


def test_server_args_carry_printall_and_force():
    from quaff_tpu.aligner import DPConfig
    from quaff_tpu.cli import _server_args

    sargs = _server_args("align", DPConfig(), {}, print_all=True)
    assert "-printall" in sargs
    sargs = _server_args("count", DPConfig(), {}, force=True)
    assert "-force" in sargs
