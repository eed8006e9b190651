"""Flag-coverage CLI tests for options no other test exercises:
banding (-kmatch/-kmatchn/-kmatchband), output thresholding
(-threshold), null-model artifacts (-savenull/-null), training control
(-mininc/-maxreadmb/-suborder/-gaporder/-savecountswithprior,
-checkpoint), and -version.  Mirrors the reference's flag semantics
(t/quaff.cpp:638-774)."""

import pytest

from quaff_tpu.cli import main

from test_cli import _run  # noqa: F401  (shared in-process runner)


def test_threshold_filters_output(data_dir):
    # tiny self-alignment scores -164.513: passes -200, filtered at -100
    base = [
        "align",
        str(data_dir / "tiny.fasta"),
        str(data_dir / "tiny.fastq"),
    ]
    rc, out = _run(base + ["-threshold", "-200"])
    assert rc == 0 and "#=GF Score -164.513" in out
    rc, out = _run(base + ["-threshold", "-100"])
    assert rc == 0 and out == ""


def test_savenull_and_null_roundtrip(data_dir, tmp_path):
    null_file = tmp_path / "null.json"
    base = [
        "align",
        str(data_dir / "tiny.fasta"),
        str(data_dir / "tiny.fastq"),
        "-nothreshold",
    ]
    rc, out1 = _run(base + ["-savenull", str(null_file)])
    assert rc == 0 and null_file.exists()
    from quaff_tpu.model.params import QuaffNullParams

    null = QuaffNullParams.from_json(null_file.read_text())
    assert 0 < null.null_emit < 1
    # reloading the saved null model reproduces the same output
    rc, out2 = _run(base + ["-null", str(null_file)])
    assert rc == 0 and out2 == out1


def test_custom_banding_flags(data_dir):
    rc, out = _run(
        [
            "align",
            str(data_dir / "c8f30.fastq.gz"),
            str(data_dir / "c8f30.fastq.gz"),
            "-fwdstrand",
            "-kmatch", "5",
            "-kmatchn", "25",
            "-kmatchband", "32",
        ]
    )
    assert rc == 0
    assert "# STOCKHOLM" in out and "#=GF Score" in out


def test_kmatch_range_check(data_dir):
    with pytest.raises(SystemExit):
        _run(
            [
                "align",
                str(data_dir / "tiny.fasta"),
                str(data_dir / "tiny.fastq"),
                "-kmatch", "4",
            ]
        )


def test_train_orders_and_artifacts(data_dir, tmp_path):
    cwp = tmp_path / "cwp.json"
    params_file = tmp_path / "params.json"
    rc, _ = _run(
        [
            "train",
            str(data_dir / "tiny.fasta"),
            str(data_dir / "tiny.fastq"),
            "-maxiter", "1",
            "-force",
            "-suborder", "1",
            "-gaporder", "1",
            "-savecountswithprior", str(cwp),
            "-saveparams", str(params_file),
        ]
    )
    assert rc == 0
    from quaff_tpu.model.params import QuaffParamCounts, QuaffParams

    qp = QuaffParams.from_json(params_file.read_text())
    assert qp.match_kmer_len == 2  # -suborder 1 -> match order 2
    assert qp.indel_kmer_len == 1  # -gaporder 1
    counts = QuaffParamCounts.from_json(cwp.read_text())
    assert counts.match_kmer_len == 2
    # prior pseudocounts are folded in, so every count is positive
    import numpy as np

    assert np.all(np.asarray(counts.match) >= 0)
    assert float(np.sum(np.asarray(counts.match))) > 0


def test_mininc_early_convergence(data_dir, tmp_path):
    # a huge fractional-increase threshold stops EM after iteration 2
    params_file = tmp_path / "params.json"
    rc, _ = _run(
        [
            "train",
            str(data_dir / "tiny.fasta"),
            str(data_dir / "tiny.fastq"),
            "-maxiter", "50",
            "-mininc", "10",
            "-force",
            "-saveparams", str(params_file),
        ]
    )
    assert rc == 0 and params_file.exists()


def test_maxreadmb_truncates_training_set(data_dir, tmp_path):
    reads = tmp_path / "reads.fastq"
    reads.write_text(
        "@r1\nACGT\n+\nabcd\n@r2\nACGTACGTACGTACGT\n+\nabcdabcdabcdabcd\n"
    )
    params_file = tmp_path / "params.json"
    rc, _ = _run(
        [
            "train",
            str(data_dir / "tiny.fasta"),
            str(reads),
            # 4e-6 MB = 4 bases: only r1 fits (qmodel.cpp:2169-2183)
            "-maxreadmb", "0.000004",
            "-maxiter", "1",
            "-force",
            "-saveparams", str(params_file),
        ]
    )
    assert rc == 0 and params_file.exists()


def test_checkpoint_flag_writes_state(data_dir, tmp_path):
    ckpt = tmp_path / "ckpt"
    rc, _ = _run(
        [
            "train",
            str(data_dir / "tiny.fasta"),
            str(data_dir / "tiny.fastq"),
            "-maxiter", "2",
            "-force",
            "-checkpoint", str(ckpt),
        ]
    )
    assert rc == 0
    assert (ckpt / "state.json").exists()
    assert (ckpt / "params.json").exists()


def test_version_flag():
    assert main(["-version"]) == 0


def test_explicit_ref_read_flags_match_implicit(data_dir):
    """Explicit -ref/-read switches are equivalent to bare filename args
    (optparser.cpp:32-54 implicit-switch inference)."""
    implicit = [
        "align",
        str(data_dir / "tiny.fasta"),
        str(data_dir / "tiny.fastq"),
        "-nothreshold",
    ]
    explicit = [
        "align",
        "-ref", str(data_dir / "tiny.fasta"),
        "-read", str(data_dir / "tiny.fastq"),
        "-nothreshold",
    ]
    rc1, out1 = _run(implicit)
    rc2, out2 = _run(explicit)
    assert rc1 == rc2 == 0
    assert out1 == out2 and "# STOCKHOLM" in out1


def test_thread_flags_accepted(data_dir):
    """-threads N / -maxthreads tune worker counts without changing output
    (qmodel.cpp:857-858; outputs are deterministic read-order here)."""
    base = [
        "align",
        str(data_dir / "tiny.fasta"),
        str(data_dir / "tiny.fastq"),
        "-nothreshold",
    ]
    rc0, out0 = _run(base)
    rc1, out1 = _run(base + ["-threads", "2"])
    rc2, out2 = _run(base + ["-maxthreads"])
    assert rc0 == rc1 == rc2 == 0
    assert out1 == out0 and out2 == out0


def test_help_command():
    """help/-help/--help/-h print the usage text (QuaffUsage,
    t/quaff.cpp:638-774)."""
    import contextlib
    import io

    for arg in ("help", "-help", "--help", "-h"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main([arg])
        text = out.getvalue()
        assert rc == 0
        for word in ("Usage", "train", "align", "overlap", "count"):
            assert word in text


def test_verbosity_flags_accepted(data_dir):
    """-v/-vN/-verbose and -nocolor parse and don't perturb output."""
    base = [
        "align",
        str(data_dir / "tiny.fasta"),
        str(data_dir / "tiny.fastq"),
        "-nothreshold",
    ]
    rc0, out0 = _run(base)
    rc1, out1 = _run(base + ["-v2", "-nocolor"])
    rc2, out2 = _run(base + ["-verbose", "-nocolor"])
    assert rc0 == rc1 == rc2 == 0
    assert out1 == out0 and out2 == out0


def test_qsub_header_and_opts(data_dir, tmp_path, monkeypatch):
    """-qsubheader prepends the header file to job.sh and -qsubopts rides
    the submission command line (makeQsubScript, qmodel.cpp:1030-1039)."""
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("QUAFF_TPU_X64", "1")
    header = tmp_path / "header.sh"
    header.write_text("#!/bin/sh\n# PBS -l walltime=1:00:00\n")
    base = [
        "align",
        str(data_dir / "tiny.fasta"),
        str(data_dir / "tiny.fastq"),
        "-nothreshold",
    ]
    rc0, out0 = _run(base)
    rc, out = _run(
        base
        + [
            "-qsubjobs", "1",
            "-qsubpath", "/bin/sh",
            # harmless shell option, forwarded verbatim to the submitter
            "-qsubopts", "-e",
            "-qsubdir", str(tmp_path / "jobs"),
            "-qsubheader", str(header),
        ]
    )
    assert rc == rc0 == 0 and out == out0
    script = (tmp_path / "jobs" / "job1" / "job.sh").read_text()
    assert script.startswith("#!/bin/sh\n# PBS -l walltime=1:00:00\n")


def test_sshkey_and_remotepath_parse():
    """-sshkey feeds ssh -i; -remotepath overrides the worker command
    (makeSshCommand qmodel.cpp:1131-1144; -remotepath t/quaff.cpp)."""
    from collections import deque

    from quaff_tpu.aligner import DPConfig
    from quaff_tpu.bootstrap import RemoteServerSpec, SshLauncher
    from quaff_tpu.cli import _parse_dp_config

    config = DPConfig()
    args = deque(["-sshkey", "/tmp/id_quaff", "-remotepath", "/opt/quaff-worker"])
    while args:
        assert _parse_dp_config(args, config)
    assert config.ssh_key == "/tmp/id_quaff"
    assert config.worker_path == "/opt/quaff-worker"

    launcher = SshLauncher("ssh", config.ssh_key)
    cmd = launcher.command(
        RemoteServerSpec(addr="host", port=8000, user="me"), "echo hi"
    )
    i = cmd.index("-i")
    assert cmd[i + 1] == "/tmp/id_quaff"
    assert cmd[-2:] == ["me@host", "echo hi"]


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_location(tmp_path, monkeypatch, env_dir):
    """The persistent compile cache lands where JAX_COMPILATION_CACHE_DIR
    says (the helper then sets nothing), and in <checkout>/.jax_cache
    when it is unset."""
    import pathlib

    import jax

    from quaff_tpu.device import setup_compile_cache

    seen = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: seen.append((k, v)))
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        setup_compile_cache()
        assert seen == []
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        setup_compile_cache()
        root = pathlib.Path(__file__).resolve().parent.parent
        assert seen == [("jax_compilation_cache_dir", str(root / ".jax_cache"))]
