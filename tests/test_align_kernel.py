"""The align kernel (dp/align_kernel) on the CPU: its lowering for CUDA
through the Triton route, its f32 scores against the f64 XLA fill across
quality modes, k-mer contexts and local/global mode (in the Pallas
interpreter), and the host-side helpers that size and shape its batches.
The kernel's compiled run on a GPU is `test_kernel_on_gpu`."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quaff_tpu.dp import align_kernel
from quaff_tpu.dp.engine import PairBatch, device_batch, device_tables, dp_fill
from quaff_tpu.dp.scores import ScoreTables
from quaff_tpu.model.params import QuaffParams, default_params

from test_pallas_v2 import _random_pairs


def _tables(gap_order: int):
    if gap_order == 0:
        return ScoreTables.from_params(default_params())
    qp = default_params()
    qp1 = QuaffParams.create(1, 1)
    qp1.ref_base = qp.ref_base
    qp1.extend_insert, qp1.extend_delete = qp.extend_insert, qp.extend_delete
    qp1.begin_insert[:] = qp.begin_insert[0] * np.linspace(0.5, 1.5, 4)
    qp1.begin_delete[:] = qp.begin_delete[0] * np.linspace(1.5, 0.5, 4)
    qp1.insert_prob, qp1.insert_q, qp1.insert_r = (
        qp.insert_prob, qp.insert_q, qp.insert_r
    )
    qp1.match_prob, qp1.match_q, qp1.match_r = qp.match_prob, qp.match_q, qp.match_r
    return ScoreTables.from_params(qp1)


@pytest.mark.parametrize("layout", ["band", "packed"])
@pytest.mark.parametrize("local", [True, False])
def test_kernel_lowers_for_cuda(layout, local):
    """The compiled route lowers for CUDA without a card: one Triton
    custom call with one program per pair."""
    rng = np.random.default_rng(1)
    tables = ScoreTables.from_params(default_params())
    build = PairBatch.build if layout == "band" else PairBatch.build_packed
    bdev = device_batch(build(_random_pairs(rng, 4), tables))
    fn = partial(
        align_kernel._viterbi_scores, local=local, reach=None,
        return_segments=layout == "packed", interpret=False,
    )
    text = (
        jax.jit(fn).trace(device_tables(tables), bdev)
        .lower(lowering_platforms=("cuda",)).as_text()
    )
    assert "__gpu$xla.gpu.triton" in text
    assert "quaff_align_viterbi" in text
    assert "grid_x = 4 : i32" in text


@pytest.mark.parametrize("with_qual", [True, False])
@pytest.mark.parametrize("gap_order", [0, 1])
@pytest.mark.parametrize("local", [True, False])
def test_kernel_matches_f64(with_qual, gap_order, local):
    rng = np.random.default_rng(5 + gap_order)
    tables = _tables(gap_order)
    pairs = _random_pairs(rng, 4, with_qual=with_qual)
    tdev = device_tables(tables)
    ref = np.asarray(
        dp_fill(tdev, device_batch(PairBatch.build(pairs, tables)),
                mode="viterbi", local=local, dtype=jnp.float64)["score"]
    )
    got = np.asarray(
        align_kernel.viterbi_scores(
            tdev, device_batch(PairBatch.build_packed(pairs, tables)),
            local=local,
        )
    )
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=0, atol=1e-3)


def test_kernel_rebase_keeps_long_paths_exact():
    """A 1,500-row path scores to within 1e-2 nat of f64: the per-row
    rebasing holds f32 rounding to per-row magnitudes."""
    from quaff_tpu.envelope import sparse_envelope
    from quaff_tpu.io.fastseq import FastSeq, KmerIndex

    rng = np.random.default_rng(9)
    xs = "".join("ACGT"[t] for t in rng.integers(0, 4, 1600))
    ys = list(xs[50:1550])
    for i in range(len(ys)):
        if rng.random() < 0.05:
            ys[i] = "ACGT"[int(rng.integers(0, 4))]
    y = FastSeq(
        name="y", seq="".join(ys),
        qual="".join(chr(33 + int(q)) for q in rng.integers(3, 40, len(ys))),
    )
    x = FastSeq(name="x", seq=xs)
    env = sparse_envelope(x, KmerIndex(y, 6), band_size=32, kmer_threshold=14)
    tables = ScoreTables.from_params(default_params())
    tdev = device_tables(tables)
    bdev = device_batch(PairBatch.build([(x, y, env)], tables))
    ref = float(dp_fill(tdev, bdev, mode="viterbi", dtype=jnp.float64)["score"][0])
    got = float(align_kernel.viterbi_scores(tdev, bdev)[0])
    assert abs(got - ref) < 1e-2


def test_kernel_rejects_blocks_wider_than_its_cap(monkeypatch):
    rng = np.random.default_rng(2)
    tables = ScoreTables.from_params(default_params())
    bdev = device_batch(PairBatch.build(_random_pairs(rng, 2), tables))
    monkeypatch.setattr(align_kernel, "MAX_LANES", 64)
    with pytest.raises(ValueError, match="exceeds"):
        align_kernel.viterbi_scores(device_tables(tables), bdev)


def test_kernel_shape_helpers():
    assert align_kernel.kernel_width(1) == 16
    assert align_kernel.kernel_width(200) == 256
    assert align_kernel.kernel_width(256) == 256
    assert align_kernel.scan_reach(np.array([[130, 40, 0]])) == 256
    assert align_kernel.scan_reach(np.array([[0, 0, 0]])) == 1
    # the per-pair footprint grows with rows and with the padded block
    b = align_kernel.bytes_per_pair(200, 6656, 6604)
    assert b == align_kernel.bytes_per_pair(256, 6656, 6604)
    assert b < align_kernel.bytes_per_pair(257, 6656, 6604)
    assert b < align_kernel.bytes_per_pair(200, 7168, 6604)


@pytest.mark.gpu
def test_kernel_on_gpu(gpu):
    """The compiled kernel on the card against the f64 fill."""
    rng = np.random.default_rng(4)
    tables = ScoreTables.from_params(default_params())
    pairs = _random_pairs(rng, 16)
    tdev = device_tables(tables)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        ref = np.asarray(
            dp_fill(
                device_tables(tables),
                device_batch(PairBatch.build(pairs, tables)),
                mode="viterbi", dtype=jnp.float64,
            )["score"]
        )
    got = np.asarray(
        align_kernel.viterbi_scores(
            tdev, device_batch(PairBatch.build_packed(pairs, tables))
        )
    )
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
