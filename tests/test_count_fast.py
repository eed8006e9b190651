"""`count -fast`: the production-precision E-step (f32; on the GPU where
there is one; `-mesh`-shardable) as an opt-in replacement for the
f64 CPU parity artifact (reference workload: t/quaff.cpp:183-211).

The documented tolerance (docs/manual.md "count -fast"): every count
entry matches the f64 parity artifact within 5e-3 + 5e-3·|count|
(absolute + relative, as asserted below).  The structure (keys, array
shapes) must be identical.
"""

import contextlib
import io
import json

from quaff_tpu.cli import main


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _args(data_dir, *extra):
    return [
        "count",
        str(data_dir / "synth12-genome.fasta"),
        str(data_dir / "synth12.fastq"),
        "-kmatchn", "10", "-fwdstrand",
        *extra,
    ]


def _assert_close(a, b, path=""):
    """Same-structure JSON compare with the documented count tolerance."""
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        err = abs(float(a) - float(b))
        assert err <= 5e-3 + 5e-3 * abs(float(b)), (path, a, b)
        return
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_close(a[k], b[k], path + "/" + k)
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_close(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def test_count_fast_matches_parity(data_dir):
    rc, parity = _run(_args(data_dir))
    assert rc == 0
    rc, fast = _run(_args(data_dir, "-fast"))
    assert rc == 0
    _assert_close(json.loads(fast), json.loads(parity))


def test_count_fast_mesh_matches_parity(data_dir):
    import jax
    import pytest

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    rc, parity = _run(_args(data_dir))
    assert rc == 0
    rc, fast = _run(_args(data_dir, "-fast", "-mesh"))
    assert rc == 0
    _assert_close(json.loads(fast), json.loads(parity))
