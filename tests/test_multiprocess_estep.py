"""True multi-controller loopback test: 2 OS processes, one global mesh.

The reference proves its distributed backend with a loopback test — the
client really sshes to localhost, starts a real second process, and the
merged output must be byte-identical to the single-process golden
(Makefile:158-176).  The device-mesh equivalent: two REAL processes join
one jax.distributed cluster (parallel/distributed.init_distributed), form
an 8-device (dp=4, mp=2) global CPU mesh, and run the shard_map E-step
with cross-process Gloo collectives; the psum'd count totals must match
the single-process forward-backward reference.
"""

import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from quaff_tpu.aligner import DPConfig, FWDBACK_CELL_SIZE  # noqa: E402
from quaff_tpu.dp.counts import dp_forward_backward  # noqa: E402
from quaff_tpu.dp.engine import PairBatch, device_batch, device_tables  # noqa: E402
from quaff_tpu.dp.scores import ScoreTables  # noqa: E402
from quaff_tpu.io.fastseq import KmerIndex  # noqa: E402
from quaff_tpu.model.params import QuaffNullParams, default_params  # noqa: E402

WORKER = pathlib.Path(__file__).parent / "_mp_estep_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_estep_matches_single_process(tmp_path):
    port = _free_port()
    out = tmp_path / "mp_counts.npz"
    import os

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    repo = str(pathlib.Path(__file__).parent.parent)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(pid), str(port), str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        )
        for pid in (0, 1)
    ]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process worker timed out")
        logs.append(stdout.decode(errors="replace"))
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{log[-3000:]}"
    assert out.exists(), logs[0][-3000:]
    got = dict(np.load(out))

    # single-process reference: plain forward-backward + posterior weights
    sys.path.insert(0, str(WORKER.parent))
    try:
        from _mp_estep_worker import make_data
    finally:
        sys.path.pop(0)
    refs, reads = make_data()
    params = default_params()
    tables = ScoreTables.from_params(params)
    tdev = device_tables(tables)
    null = QuaffNullParams.fit(reads)
    nll = np.asarray([null.log_likelihood(y) for y in reads], np.float64)

    config = DPConfig(sparse=False)
    pairs = []
    for y in reads:
        yi = KmerIndex(y, config.kmer_len)
        for x in refs:
            pairs.append((x, y, config.make_envelope(x, yi, FWDBACK_CELL_SIZE)))
    res = dp_forward_backward(
        tdev, device_batch(PairBatch.build(pairs, tables)),
        local=True, dtype=jnp.float32,
        num_match_kmers=params.num_match_kmers,
        num_indel_kmers=params.num_indel_kmers,
    )
    fwd = np.asarray(res["fwd_score"], np.float64).reshape(
        len(reads), len(refs)
    )
    y_ll = np.array([
        np.logaddexp.reduce(np.concatenate([[nll[r]], fwd[r]]))
        for r in range(len(reads))
    ])
    w = np.exp(fwd - y_ll[:, None]).reshape(-1)

    np.testing.assert_allclose(float(got["loglike"]), y_ll.sum(), rtol=1e-5)
    for name in ("match_counts", "insert_counts", "m2m", "m2i", "m2d",
                 "m2e", "i2i", "i2m", "d2d", "d2m"):
        want = np.tensordot(w, np.asarray(res[name], np.float64), axes=(0, 0))
        np.testing.assert_allclose(
            np.asarray(got[name], np.float64), want,
            rtol=2e-4, atol=2e-4, err_msg=name,
        )
