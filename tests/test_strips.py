"""Strip decomposition: multi-cluster envelopes split into independent
diagonal strips whose combined scores equal the bounding-band fill."""

import numpy as np
import pytest

import jax.numpy as jnp

from quaff_tpu.dp.engine import (
    PairBatch,
    combine_strip_scores,
    device_batch,
    device_tables,
    dp_fill,
    expand_strips,
)
from quaff_tpu.dp.scores import ScoreTables
from quaff_tpu.envelope import make_envelope
from quaff_tpu.io.fastseq import KmerIndex, read_fast_seqs
from quaff_tpu.model.params import default_params


@pytest.fixture(scope="module")
def c8f30_pair(data_dir):
    y = read_fast_seqs(str(data_dir / "c8f30.fastq.gz"))[0]
    x = read_fast_seqs(str(data_dir / "c8f30.fastq.gz"))[0]
    x.qual = ""
    env = make_envelope(x, KmerIndex(y, 6), kmer_threshold=14, cell_size=24)
    return x, y, env


def test_strips_partition_diagonals(c8f30_pair):
    _, _, env = c8f30_pair
    strips = env.strips()
    assert len(strips) == 3  # self-alignment: repeat clusters at +-~170
    got = np.concatenate([s.diagonals for s in strips])
    np.testing.assert_array_equal(got, env.diagonals)
    for s in strips:
        assert np.all(np.diff(s.diagonals) == 1)
    assert sum(s.num_cells for s in strips) == env.num_cells
    # strips are narrower than the bounding band
    assert max(s.band_width for s in strips) < env.band_width


@pytest.mark.parametrize("mode", ["viterbi", "forward"])
def test_strip_scores_match_bounding_band(c8f30_pair, mode):
    x, y, env = c8f30_pair
    tables = ScoreTables.from_params(default_params())
    tdev = device_tables(tables)

    full = dp_fill(
        tdev,
        device_batch(PairBatch.build([(x, y, env)], tables)),
        mode=mode,
        local=True,
        return_matrices=False,
        dtype=jnp.float64,
    )["score"]

    strip_pairs, owner = expand_strips([(x, y, env)])
    assert len(strip_pairs) == 3
    per_strip = dp_fill(
        tdev,
        device_batch(PairBatch.build(strip_pairs, tables)),
        mode=mode,
        local=True,
        return_matrices=False,
        dtype=jnp.float64,
    )["score"]
    combined = combine_strip_scores(per_strip, owner, 1, mode=mode)
    np.testing.assert_allclose(
        combined, np.asarray(full, dtype=np.float64), rtol=1e-12, atol=1e-9
    )


def test_single_run_envelope_is_one_strip(c8f30_pair):
    x, y, _ = c8f30_pair
    env = make_envelope(x, KmerIndex(y, 6), kmer_threshold=20, cell_size=24)
    strips = env.strips()
    assert len(strips) == 1
    np.testing.assert_array_equal(strips[0].diagonals, env.diagonals)


def _synthetic_multistrip(rng, n, yl=90):
    """Pairs whose reads match two separated regions of the ref, giving
    multi-run envelopes."""
    from quaff_tpu.alphabet import DNA_ALPHABET
    from quaff_tpu.envelope import sparse_envelope
    from quaff_tpu.io.fastseq import FastSeq

    out = []
    for b in range(n):
        core = "".join(DNA_ALPHABET[t] for t in rng.integers(0, 4, yl))
        spacer = "".join(DNA_ALPHABET[t] for t in rng.integers(0, 4, 160))
        xs = core + spacer + core  # repeat -> two seed clusters
        ys = list(core)
        for i in range(len(ys)):
            if rng.random() < 0.06:
                ys[i] = DNA_ALPHABET[int(rng.integers(0, 4))]
        y = FastSeq(
            name=f"y{b}",
            seq="".join(ys),
            qual="".join(chr(33 + int(q)) for q in rng.integers(3, 40, yl)),
        )
        x = FastSeq(name=f"x{b}", seq=xs)
        env = sparse_envelope(x, KmerIndex(y, 6), band_size=64, kmer_threshold=10)
        out.append((x, y, env))
    return out


@pytest.mark.parametrize("local", [True, False])
def test_packed_kernel_matches_legacy(local):
    """Lane-packed strip batches must score identically (f32) to the
    bounding-band layout in the align kernel."""
    from quaff_tpu.dp.align_kernel import viterbi_scores

    rng = np.random.default_rng(21)
    tables = ScoreTables.from_params(default_params())
    pairs = _synthetic_multistrip(rng, 4)
    assert any(len(e.strips()) >= 2 for _, _, e in pairs)

    tdev = device_tables(tables)
    legacy = np.asarray(viterbi_scores(
        tdev, device_batch(PairBatch.build(pairs, tables)), local=local,
    ))
    packed_b = PairBatch.build_packed(pairs, tables)
    assert packed_b.member.shape[1] < PairBatch.build(pairs, tables).member.shape[1]
    packed = np.asarray(viterbi_scores(
        tdev, device_batch(packed_b), local=local,
    ))
    np.testing.assert_allclose(packed, legacy, rtol=1e-5, atol=1e-3)


def test_packed_kernel_segment_scores():
    """return_segments: per-strip scores from the packed kernel must
    match independent per-strip fills (pack_strips order), and the pair
    score must equal the max over its strips."""
    from quaff_tpu.dp.align_kernel import viterbi_scores
    from quaff_tpu.envelope import pack_strips

    rng = np.random.default_rng(27)
    tables = ScoreTables.from_params(default_params())
    pairs = _synthetic_multistrip(rng, 4)
    assert any(len(pack_strips(e, 3)) >= 2 for _, _, e in pairs)

    tdev = device_tables(tables)
    packed_b = PairBatch.build_packed(pairs, tables)
    scores, segmax = viterbi_scores(
        tdev, device_batch(packed_b), local=True, return_segments=True,
    )
    scores, segmax = np.asarray(scores), np.asarray(segmax)
    n_segs = packed_b.seg_d_lo.shape[1]

    tdev = device_tables(tables)
    for b, (x, y, env) in enumerate(pairs):
        strips = pack_strips(env, 3)
        per_strip = np.asarray(dp_fill(
            tdev,
            device_batch(PairBatch.build([(x, y, s) for s in strips], tables)),
            mode="viterbi", local=True, return_matrices=False,
            dtype=jnp.float64,
        )["score"])
        finite = np.isfinite(per_strip)
        got = segmax[b, : len(strips)]
        np.testing.assert_allclose(
            got[finite], per_strip[finite], rtol=1e-5, atol=1e-3
        )
        assert np.all(got[~finite] <= -1e30) or np.all(
            ~np.isfinite(got[~finite])
        )
        # absent segments rank below every real strip
        for k in range(len(strips), n_segs):
            assert not np.isfinite(segmax[b, k]) or segmax[b, k] <= -1e30
        np.testing.assert_allclose(
            scores[b], np.max(per_strip), rtol=1e-5, atol=1e-3
        )


def test_packed_estep_matches_engine(monkeypatch):
    """The batched device E-step (QuaffCounter._get_counts_batched: one
    f32 dp_forward_backward per bucket, host-side weighting) matches the
    f64 per-read engine on multi-strip envelopes within the count -fast
    tolerance."""
    from quaff_tpu.aligner import DPConfig
    from quaff_tpu.model.params import QuaffNullParams
    from quaff_tpu.trainer import QuaffCounter

    rng = np.random.default_rng(23)
    pairs = _synthetic_multistrip(rng, 3)
    ref = pairs[0][0]
    reads = [y for _, y, _ in pairs]
    null = QuaffNullParams.fit(reads)
    cfg = DPConfig(kmer_threshold=10)
    exact = QuaffCounter(default_params(), null, cfg, prefer_device=False)
    c64, ll64, o64 = exact.get_counts([ref], reads)

    cfg32 = DPConfig(kmer_threshold=10, dtype=jnp.float32)
    dev = QuaffCounter(default_params(), null, cfg32)
    monkeypatch.setattr(dev, "_use_device", lambda: True)
    c32, ll32, o32 = dev.get_counts([ref], reads)
    assert o32 == o64
    assert abs(ll32 - ll64) <= 5e-3 + 5e-3 * abs(ll64)
    for name in (
        "match", "insert", "begin_insert_no", "begin_insert_yes",
        "begin_delete_no", "begin_delete_yes", "extend_insert_no",
        "extend_insert_yes", "extend_delete_no", "extend_delete_yes",
    ):
        a, b = np.asarray(getattr(c32, name)), np.asarray(getattr(c64, name))
        assert np.all(np.abs(a - b) <= 5e-3 + 5e-3 * np.abs(b)), name


def test_dp_fill_rejects_packed():
    rng = np.random.default_rng(25)
    tables = ScoreTables.from_params(default_params())
    pairs = _synthetic_multistrip(rng, 2)
    tdev = device_tables(tables)
    with pytest.raises(ValueError, match="packed"):
        dp_fill(
            tdev, device_batch(PairBatch.build_packed(pairs, tables)),
            mode="viterbi", local=True, return_matrices=False,
            dtype=jnp.float32,
        )


def test_host_batch_matches_device_batch():
    """host_batch is device_batch's numpy twin (mesh paths stack host
    arrays before one global transfer); keys, dtypes and values must
    stay in lockstep if either gains a field."""
    import numpy as np

    from quaff_tpu.dp.engine import PairBatch, device_batch, host_batch
    from quaff_tpu.dp.scores import ScoreTables
    from quaff_tpu.envelope import sparse_envelope
    from quaff_tpu.io.fastseq import FastSeq, KmerIndex
    from quaff_tpu.model.params import default_params

    x = FastSeq(name="x", seq="ACGTACGTACGTACGTACGT")
    y = FastSeq(name="y", seq="ACGTACGAACGT", qual="IIIIIIIIIIII")
    env = sparse_envelope(x, KmerIndex(y, 6), band_size=16, kmer_threshold=1)
    tables = ScoreTables.from_params(default_params())
    for build in (PairBatch.build, PairBatch.build_packed):
        batch = build([(x, y, env)] * 2, tables)
        dev = device_batch(batch)
        host = host_batch(batch)
        assert set(dev) == set(host)
        for k in dev:
            d = np.asarray(dev[k])
            h = np.asarray(host[k])
            assert d.dtype == h.dtype, k
            np.testing.assert_array_equal(d, h, err_msg=k)


def test_packed_kernel_max_prop_invariant():
    """Bounding the delete-scan reach at the widest strip (pow2) must not
    change any packed-kernel score: halo lanes already stop legal
    propagation at strip seams."""
    from quaff_tpu.dp.align_kernel import scan_reach, viterbi_scores

    rng = np.random.default_rng(29)
    tables = ScoreTables.from_params(default_params())
    tdev = device_tables(tables)
    pairs = _synthetic_multistrip(rng, 4)
    b = PairBatch.build_packed(pairs, tables)
    reach = scan_reach(b.seg_width)
    assert reach < 128 * 2  # strips are narrow here
    for local in (True, False):
        full = np.asarray(viterbi_scores(tdev, device_batch(b), local=local))
        capped = np.asarray(viterbi_scores(
            tdev, device_batch(b), local=local, reach=reach,
        ))
        np.testing.assert_array_equal(capped, full)
