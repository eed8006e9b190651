"""Multi-host CLI loopback test: the PRODUCT (quaff-tpu train -mesh) run
as a real 2-process jax.distributed cluster.

The reference proves its scale-out through the product: the client
sshes to localhost, starts a real worker process, and the merged output
must be byte-identical to the single-process golden (Makefile:158-176,
control plane qmodel.cpp:1093-1125).  The device-mesh equivalent here:
two OS processes each run the SAME `quaff-tpu train ... -mesh
-coordinator 127.0.0.1:PORT -nprocs 2 -procid I` command, join one
jax.distributed cluster (4 virtual CPU devices each -> one global
8-device dp mesh), run the sharded E-step with cross-process Gloo
collectives, and host 0's params output must match the single-process
8-device `-mesh` run.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

from quaff_tpu.alphabet import DNA_ALPHABET

REPO = str(pathlib.Path(__file__).parent.parent)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_data(tmp_path):
    rng = np.random.default_rng(91)
    ref_seq = "".join(DNA_ALPHABET[t] for t in rng.integers(0, 4, 150))
    (tmp_path / "ref.fasta").write_text(f">genome\n{ref_seq}\n")
    lines = []
    for i in range(6):  # 6 reads on dp=8: exercises sentinel padding too
        start = int(rng.integers(0, 30))
        toks = [
            int(rng.integers(0, 4)) if rng.random() < 0.05
            else DNA_ALPHABET.index(c)
            for c in ref_seq[start : start + 100]
        ]
        seq = "".join(DNA_ALPHABET[t] for t in toks)
        qual = "".join(chr(33 + int(q)) for q in rng.integers(5, 30, len(seq)))
        lines.append(f"@read{i}\n{seq}\n+\n{qual}\n")
    (tmp_path / "reads.fastq").write_text("".join(lines))


def _cli_env(n_devices: int) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={n_devices}"
    )
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _base_args(tmp_path):
    return [
        sys.executable, "-m", "quaff_tpu.cli", "train",
        str(tmp_path / "ref.fasta"), str(tmp_path / "reads.fastq"),
        "-fwdstrand", "-force", "-maxiter", "2", "-mesh",
    ]


def test_two_process_cli_train_matches_single_process(tmp_path):
    _write_data(tmp_path)

    # single-process baseline: same 8-device mesh, one controller
    single = subprocess.run(
        _base_args(tmp_path), capture_output=True, env=_cli_env(8),
        timeout=420,
    )
    assert single.returncode == 0, single.stderr.decode()[-3000:]
    assert single.stdout, "single-process run produced no params"

    port = _free_port()
    procs = [
        subprocess.Popen(
            _base_args(tmp_path)
            + ["-coordinator", f"127.0.0.1:{port}",
               "-nprocs", "2", "-procid", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=_cli_env(4),
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-host CLI run timed out")
        outs.append((stdout, stderr))
    for pid, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"process {pid} failed:\n{stderr.decode()[-3000:]}"
        )

    def strip_gloo(raw: bytes) -> str:
        # the Gloo transport prints rank banners on stdout at cluster
        # init (sometimes interleaved mid-line); the params JSON is
        # written afterwards, from the first line that is exactly "{"
        text = raw.decode()
        idx = text.find("\n{\n")
        if idx >= 0:
            return text[idx + 1 :]
        return text if text.startswith("{\n") else ""

    # host 0 owns the output; host 1 must write none
    assert strip_gloo(outs[1][0]) == "", "non-primary process wrote params"
    got = strip_gloo(outs[0][0])
    want = single.stdout.decode()
    assert got, "primary process wrote no params"
    if got != want:
        # cross-process Gloo reductions may round differently from the
        # single-controller collective; require numeric agreement at f64
        # reduction-order tolerance if the bytes differ
        a, b = json.loads(got), json.loads(want)

        def close(x, y, path=""):
            if isinstance(x, dict):
                assert x.keys() == y.keys(), path
                for k in x:
                    close(x[k], y[k], f"{path}/{k}")
            elif isinstance(x, list):
                assert len(x) == len(y), path
                for i, (u, v) in enumerate(zip(x, y)):
                    close(u, v, f"{path}[{i}]")
            elif isinstance(x, (int, float)) and not isinstance(x, bool):
                np.testing.assert_allclose(
                    x, y, rtol=1e-9, atol=1e-12, err_msg=path
                )
            else:
                assert x == y, path

        close(a, b)


def test_two_process_cli_align_matches_single_process(tmp_path):
    _write_data(tmp_path)
    align_args = [
        sys.executable, "-m", "quaff_tpu.cli", "align",
        str(tmp_path / "ref.fasta"), str(tmp_path / "reads.fastq"),
        "-fwdstrand", "-nothreshold", "-mesh",
    ]
    single = subprocess.run(
        align_args, capture_output=True, env=_cli_env(8), timeout=420,
    )
    assert single.returncode == 0, single.stderr.decode()[-3000:]

    port = _free_port()
    procs = [
        subprocess.Popen(
            align_args
            + ["-coordinator", f"127.0.0.1:{port}",
               "-nprocs", "2", "-procid", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=_cli_env(4),
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=420))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-host align timed out")
    for pid, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"process {pid} failed:\n{stderr.decode()[-3000:]}"
        )

    def strip_gloo(raw: bytes) -> str:
        text = raw.decode()
        idx = text.find("# STOCKHOLM")
        return text[idx:] if idx >= 0 else ""

    assert strip_gloo(outs[1][0]) == "", "non-primary process wrote output"
    got = strip_gloo(outs[0][0])
    assert got == single.stdout.decode()


def _run_pair(args_for, timeout=420):
    port = _free_port()
    procs = [
        subprocess.Popen(
            args_for(pid) + ["-coordinator", f"127.0.0.1:{port}",
                             "-nprocs", "2", "-procid", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=_cli_env(4),
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-host pair timed out")
    return procs, outs


def test_multihost_checkpoint_desync_detected(tmp_path):
    """Only host 0 writes EM checkpoints; if the hosts' -checkpoint dirs
    are NOT a shared filesystem, a resume would silently diverge the
    SPMD steps — the trainer must detect it and fail clearly."""
    _write_data(tmp_path)

    def args_for(pid):
        # deliberately per-host checkpoint dirs (simulating no shared FS)
        return _base_args(tmp_path) + [
            "-checkpoint", str(tmp_path / f"ckpt{pid}")
        ]

    procs, outs = _run_pair(args_for)
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-2000:]
    # run again: host 0 resumes from its checkpoint, host 1 has none
    procs, outs = _run_pair(args_for)
    assert any(p.returncode != 0 for p in procs)
    blob = b"".join(err for _, err in outs)
    assert b"desync" in blob or b"shared filesystem" in blob


def test_multihost_without_mesh_fails(tmp_path):
    """Also covers the ENV form of the cluster wiring: this pair joins
    via QUAFF_COORDINATOR/QUAFF_NPROCS/QUAFF_PROCID instead of flags
    (the cluster must be up before the -mesh check can fire on both
    processes)."""
    _write_data(tmp_path)
    port = _free_port()

    def env_for(pid):
        env = _cli_env(4)
        env["QUAFF_COORDINATOR"] = f"127.0.0.1:{port}"
        env["QUAFF_NPROCS"] = "2"
        env["QUAFF_PROCID"] = str(pid)
        return env

    procs = [
        subprocess.Popen(
            [
                sys.executable, "-m", "quaff_tpu.cli", "train",
                str(tmp_path / "ref.fasta"), str(tmp_path / "reads.fastq"),
                "-fwdstrand", "-force", "-maxiter", "1",
            ],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=env_for(pid),
        )
        for pid in (0, 1)
    ]
    for p in procs:
        try:
            _, stderr = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("processes hung instead of failing cleanly")
        assert p.returncode != 0
        assert b"require -mesh" in stderr
