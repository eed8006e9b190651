"""End-to-end elastic-cloud worker bootstrap through the CLI.

`-ec2instances N` provisions cloud instances via the aws CLI, registers
them as remote workers, and guarantees termination on exit and on fatal
signals (AWS singleton, src/aws.cpp:107-217; dispatch wiring
qmodel.cpp:1093-1125).  A stub `aws` executable answers run-instances /
wait / describe-instances with loopback addresses and records
terminate-instances calls, and a stub ssh runs the worker command
locally — so the full chain (provision, READY handshake, framed TCP
tasks, terminate-on-exit) runs in-process with no cloud.
"""

import contextlib
import io
import os
import signal
import socket
import subprocess
import sys
import textwrap

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
        "for last; do :; done\n"
        'exec sh -c "$last"\n'
    )
    stub.chmod(0o755)
    return str(stub)


def _stub_aws(tmp_path) -> str:
    """Fake `aws` CLI: ec2 run-instances/wait/describe/terminate plus
    s3 cp/sync against a local directory standing in for the bucket."""
    bucket = tmp_path / "s3-bucket"
    bucket.mkdir(exist_ok=True)
    stub = tmp_path / "fake-aws"
    stub.write_text(textwrap.dedent(f"""\
        #!/usr/bin/env python3
        import json, pathlib, shutil, sys

        args = sys.argv[1:]
        here = pathlib.Path({str(tmp_path)!r})
        bucket = here / "s3-bucket"
        (here / "aws-calls.log").open("a").write(" ".join(args) + "\\n")
        cmd = tuple(args[:2])
        if cmd == ("ec2", "run-instances"):
            n = int(args[args.index("--count") + 1])
            ids = [f"i-stub{{k}}" for k in range(n)]
            print(json.dumps({{"Instances": [{{"InstanceId": i}} for i in ids]}}))
        elif cmd == ("ec2", "wait"):
            pass
        elif cmd == ("ec2", "describe-instances"):
            ids = args[args.index("--instance-ids") + 1:]
            insts = [{{"InstanceId": i, "PublicIpAddress": "127.0.0.1"}} for i in ids]
            print(json.dumps({{"Reservations": [{{"Instances": insts}}]}}))
        elif cmd == ("ec2", "terminate-instances"):
            ids = args[args.index("--instance-ids") + 1:]
            with (here / "terminated.log").open("a") as fh:
                for i in ids:
                    fh.write(i + "\\n")
            print("{{}}")
        elif cmd == ("s3", "cp"):
            shutil.copy(args[2], bucket)
        elif cmd == ("s3", "sync"):
            name = args[args.index("--include") + 1]
            dest = pathlib.Path(args[3])
            dest.mkdir(parents=True, exist_ok=True)
            shutil.copy(bucket / name, dest)
        else:
            sys.exit(f"stub aws: unhandled {{args}}")
    """))
    stub.chmod(0o755)
    return str(stub)


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_align_via_ec2_pool(data_dir, tmp_path):
    """Full -ec2instances chain: provision via stub aws, align via the
    launched loopback worker, terminate instances after the run."""
    base = [
        "align",
        str(data_dir / "dpm_ref.fasta"),
        str(data_dir / "dpm_read.fastq"),
        "-kmatchoff",
        "-fwdstrand",
        "-nothreshold",
    ]
    rc, want = _run(base)
    assert rc == 0 and want

    aws = _stub_aws(tmp_path)
    rc, got = _run(
        base
        + [
            "-ec2instances", "1",
            "-ec2port", str(_free_port()),
            "-ec2user", "tester",
            "-sshpath", _stub_ssh(tmp_path),
            "-awspath", aws,
        ]
    )
    assert rc == 0
    assert got == want
    # the pool really was provisioned and torn down through the aws CLI
    calls = (tmp_path / "aws-calls.log").read_text()
    assert "ec2 run-instances" in calls
    assert "ec2 wait instance-status-ok" in calls
    assert (tmp_path / "terminated.log").read_text().splitlines() == ["i-stub0"]


def test_ec2_terminate_on_signal(tmp_path):
    """Fatal signals terminate provisioned instances (AWS::handleSignal
    chain, aws.cpp:179-208): a subprocess provisions via the stub aws,
    SIGTERMs itself, and the instance must appear in the terminate log."""
    aws = _stub_aws(tmp_path)
    script = (
        "import os, signal, sys\n"
        "from quaff_tpu.bootstrap import ElasticPool\n"
        f"pool = ElasticPool(aws_path={aws!r})\n"
        "addrs = pool.launch(2, 'true\\n')\n"
        "assert addrs == ['127.0.0.1', '127.0.0.1'], addrs\n"
        "os.kill(os.getpid(), signal.SIGTERM)\n"
        "raise SystemExit('signal handler did not fire')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(
        __import__("pathlib").Path(__file__).resolve().parents[1]))
    proc = subprocess.run(
        [sys.executable, "-c", script], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 128 + signal.SIGTERM, proc.stderr
    terminated = set((tmp_path / "terminated.log").read_text().split())
    assert terminated == {"i-stub0", "i-stub1"}


def test_align_with_s3_staging(data_dir, tmp_path):
    """-s3bucket stages data through the (stub) bucket: the client
    uploads every file arg, worker args are rewritten to staging paths,
    and the worker pulls them down before loading (syncToBucket /
    SeqList::syncBucket, qmodel.cpp:1062-1070, t/quaff.cpp:342-346)."""
    import shutil

    from quaff_tpu.bootstrap import SYNC_STAGING_DIR

    # data the worker can only see if bucket staging really happened
    src_dir = tmp_path / "cl"
    src_dir.mkdir()
    for fn in ("dpm_ref.fasta", "dpm_read.fastq"):
        shutil.copy(data_dir / fn, src_dir / fn)
    for fn in ("dpm_ref.fasta", "dpm_read.fastq"):
        staged = f"{SYNC_STAGING_DIR}/{fn}"
        if os.path.exists(staged):
            os.unlink(staged)

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

    aws = _stub_aws(tmp_path)
    rc, got = _run(
        base
        + [
            "-remote", f"tester@127.0.0.1:{_free_port()}",
            "-sshpath", _stub_ssh(tmp_path),
            "-awspath", aws,
            "-s3bucket", "stub-bucket",
        ]
    )
    assert rc == 0
    assert got == want
    # client pushed both files into the bucket; worker pulled them down
    assert (tmp_path / "s3-bucket" / "dpm_ref.fasta").exists()
    assert (tmp_path / "s3-bucket" / "dpm_read.fastq").exists()
    assert os.path.exists(f"{SYNC_STAGING_DIR}/dpm_ref.fasta")
