"""Banded pair-HMM DP as batched JAX row scans over a dense diagonal band.

This is the batched, accelerator-first redesign of the reference's hot loops
(QuaffViterbiMatrix / QuaffForwardMatrix ctors, src/qmodel.cpp:1343-1560).
Instead of the reference's ragged per-row envelope iteration, the DP state
for read position j is a dense vector over a contiguous range of diagonals
(the envelope's bounding band, with a membership mask pinning
out-of-envelope lanes to -inf).  In diagonal coordinates the recursion has
the structure:

  mat[w] <- f(prev row, same lane w)        (i-1, j-1) is the same diagonal
  ins[w] <- f(prev row, lane w+1)           (i,   j-1) is diagonal d+1
  del[w] <- f(THIS row,  lane w-1)          (i-1, j)   is diagonal d-1

so a row update is: an elementwise 3-term semiring combine for mat, a
shifted combine for ins, and an in-row first-order linear recurrence over
lanes for del, which is evaluated with an associative scan (max-plus for
Viterbi, log-plus for Forward) in O(log W) depth.  Everything is batched
over pairs; the row loop is a lax.scan.

Tie-breaking, start/end boundary conditions (local vs global), and the
per-row k-mer-context transition scores follow the reference exactly, so
Viterbi scores and tracebacks are bit-comparable in float64.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..envelope import Envelope
from ..io.fastseq import FastSeq
from .scores import ScoreTables

NEG_INF = -np.inf


def pow2ceil(n: int, minimum: int = 8) -> int:
    """Batch-size padding quantum: the smallest power of two >= n (floor
    `minimum`).  Kernel batches pad to these quanta so distinct chunk
    sizes do not each compile a fresh kernel shape — every chunking site
    must use the SAME quantum its batch-budget check assumed."""
    b = minimum
    while b < n:
        b *= 2
    return b


def expand_strips(pairs):
    """[(x, y, env)] -> (strip_pairs, owner): each envelope split into its
    independent diagonal strips (Envelope.strips), owner[k] = index of the
    originating pair.  Evaluating strips as separate batch rows skips the
    -inf gap lanes of a multi-cluster bounding band."""
    strip_pairs, owner = [], []
    for n, (x, y, env) in enumerate(pairs):
        for s in env.strips():
            strip_pairs.append((x, y, s))
            owner.append(n)
    return strip_pairs, owner


def combine_strip_scores(scores, owner, n_pairs, mode="viterbi"):
    """Per-owner max (viterbi) / log-sum-exp (forward) of strip scores."""
    out = np.full(n_pairs, -np.inf)
    for sc, n in zip(np.asarray(scores, dtype=np.float64), owner):
        out[n] = (
            max(out[n], sc) if mode == "viterbi" else np.logaddexp(out[n], sc)
        )
    return out


# ---------------------------------------------------------------------------
# batch assembly (host side)


@dataclass
class PairBatch:
    """Padded arrays describing a batch of (ref x, read y, envelope) pairs."""

    x_tok: np.ndarray  # [B, Lx] int32, padded with 0
    x_len: np.ndarray  # [B] int32
    y_tok: np.ndarray  # [B, Ly] int32
    y_match_kmer: np.ndarray  # [B, Ly] int32
    y_indel_kmer_pad: np.ndarray  # [B, Ly+1] int32; [:,0] = 0 (dummy)
    y_qual: np.ndarray  # [B, Ly] int32 (0 where absent)
    y_has_qual: np.ndarray  # [B] bool
    y_len: np.ndarray  # [B] int32
    d_lo: np.ndarray  # [B] int32: diagonal of lane 0 (includes -1 halo)
    member: np.ndarray  # [B, W] bool: member diagonals of the envelope
    width: int
    max_y_len: int
    # exclusive upper bounds on the kmer codes, for narrow transfer dtypes
    match_kmer_bound: int = 1 << 30
    indel_kmer_bound: int = 1 << 30
    # lane-packed strip descriptors ([B, MAX_SEGS] int32), set by
    # build_packed; None for bounding-band batches
    seg_d_lo: Optional[np.ndarray] = None
    seg_start: Optional[np.ndarray] = None
    seg_width: Optional[np.ndarray] = None

    @classmethod
    def build(
        cls,
        pairs: List[Tuple[FastSeq, FastSeq, Envelope]],
        tables: ScoreTables,
        width: Optional[int] = None,
        max_y_len: Optional[int] = None,
        max_x_len: Optional[int] = None,
    ) -> "PairBatch":
        B = len(pairs)
        Lx = max(len(x.seq) for x, _, _ in pairs)
        if max_x_len is not None:
            Lx = max(Lx, max_x_len)
        Ly = max(len(y.seq) for _, y, _ in pairs)
        if max_y_len is not None:
            Ly = max(Ly, max_y_len)
        W = max(e.band_width for _, _, e in pairs)
        if width is not None:
            W = max(W, width)
        out = cls(
            x_tok=np.zeros((B, Lx), dtype=np.int32),
            x_len=np.zeros(B, dtype=np.int32),
            y_tok=np.zeros((B, Ly), dtype=np.int32),
            y_match_kmer=np.zeros((B, Ly), dtype=np.int32),
            y_indel_kmer_pad=np.zeros((B, Ly + 1), dtype=np.int32),
            y_qual=np.zeros((B, Ly), dtype=np.int32),
            y_has_qual=np.zeros(B, dtype=bool),
            y_len=np.zeros(B, dtype=np.int32),
            d_lo=np.zeros(B, dtype=np.int32),
            member=np.zeros((B, W), dtype=bool),
            width=W,
            max_y_len=Ly,
            match_kmer_bound=4 ** tables.match_kmer_len,
            indel_kmer_bound=4 ** tables.indel_kmer_len,
        )
        for b, (x, y, env) in enumerate(pairs):
            xt = x.tokens()
            yt = y.tokens()
            ly = len(yt)
            out.x_tok[b, : len(xt)] = xt
            out.x_len[b] = len(xt)
            out.y_tok[b, :ly] = yt
            out.y_match_kmer[b, :ly] = y.kmers(tables.match_kmer_len)
            out.y_indel_kmer_pad[b, 1 : ly + 1] = y.kmers(tables.indel_kmer_len)
            if y.has_qual():
                out.y_qual[b, :ly] = y.qual_scores()
                out.y_has_qual[b] = True
            out.y_len[b] = ly
            out.d_lo[b] = env.band_lo
            mask = env.member_mask()
            out.member[b, : len(mask)] = mask
        return out

    @classmethod
    def build_packed(
        cls,
        pairs: List[Tuple[FastSeq, FastSeq, Envelope]],
        tables: ScoreTables,
        width: Optional[int] = None,
        max_y_len: Optional[int] = None,
        max_segs: int = 3,
        max_x_len: Optional[int] = None,
    ) -> "PairBatch":
        """Lane-packed strip layout for the align kernel: each pair's
        envelope is split into its independent diagonal strips (merged to
        at most max_segs) and the strips are laid side by side on the
        lane axis, so a multi-cluster envelope pays Σ strip widths lanes
        instead of its (much wider) bounding band.  Each strip keeps its
        ±1 non-member halo, which blocks the in-row recursions at the
        seams.  Only the align kernel understands this layout (it reads
        the seg_* descriptors); the XLA engine must use build()."""
        from ..envelope import pack_strips

        segs_per_pair = [pack_strips(e, max_segs) for _, _, e in pairs]

        class _PackedView:
            def __init__(self, segs):
                self.band_lo = 0  # unused by kernels for packed batches
                self.band_width = sum(s.band_width for s in segs)
                self._segs = segs

            def member_mask(self):
                return np.concatenate([s.member_mask() for s in self._segs])

        packed_pairs = [
            (x, y, _PackedView(segs))
            for (x, y, _), segs in zip(pairs, segs_per_pair)
        ]
        out = cls.build(
            packed_pairs, tables, width=width, max_y_len=max_y_len,
            max_x_len=max_x_len,
        )
        B = len(pairs)
        # sentinel diagonal for absent segments (matches the kernels'
        # D_SENTINEL: rows are always out of x range there)
        out.seg_d_lo = np.full((B, max_segs), 1 << 24, dtype=np.int32)
        out.seg_start = np.zeros((B, max_segs), dtype=np.int32)
        out.seg_width = np.zeros((B, max_segs), dtype=np.int32)
        for b, segs in enumerate(segs_per_pair):
            lane = 0
            for k, s in enumerate(segs):
                out.seg_d_lo[b, k] = s.band_lo
                out.seg_start[b, k] = lane
                out.seg_width[b, k] = s.band_width
                lane += s.band_width
        return out


# ---------------------------------------------------------------------------
# semirings


def _max_combine(a, b):
    return jnp.maximum(a, b)


def _lse_combine(a, b):
    return jnp.logaddexp(a, b)


def two_sum(a, b):
    """(s, e) with s = fl(a + b) and a + b = s + e exactly (Knuth's
    TwoSum).  The f32 device fills carry each pair's running score offset
    as such a pair of floats (per-row rebasing)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _linear_recurrence(combine, c_vec, b_vec):
    """x[w] = combine(x[w-1] + c[w], b[w]) with x[-1] = -inf, via an
    associative scan over the last axis."""

    def op(left, right):
        c1, b1 = left
        c2, b2 = right
        return c1 + c2, combine(b1 + c2, b2)

    _, x = jax.lax.associative_scan(op, (c_vec, b_vec), axis=-1)
    return x


def _linear_recurrence_seq(combine, c_vec, b_vec):
    """Strictly sequential x[w] = combine(x[w-1] + c[w], b[w]) over lanes.

    The associative-scan form above composes the +c offsets in log-depth
    doubling order, whose rounding sequence differs from the reference's
    lane-at-a-time C++ loop (qmodel.cpp:1546-1547) by ulps — enough to
    flip equal-scoring delete placements in repeat regions.  The f64
    Viterbi parity path uses this sequential scan instead (round 4)."""

    def step(x_prev, cb):
        c, b = cb
        x = combine(x_prev + c, b)
        return x, x

    init = jnp.full(b_vec.shape[:-1], -jnp.inf, b_vec.dtype)
    _, xs = jax.lax.scan(
        step, init, (jnp.moveaxis(c_vec, -1, 0), jnp.moveaxis(b_vec, -1, 0))
    )
    return jnp.moveaxis(xs, 0, -1)


# ---------------------------------------------------------------------------
# DP fill


@partial(
    jax.jit,
    static_argnames=("mode", "local", "return_matrices", "dtype", "neg_inf_value"),
)
def dp_fill(
    tables_dev: dict,
    batch_dev: dict,
    mode: str = "viterbi",
    local: bool = True,
    return_matrices: bool = False,
    dtype=jnp.float32,
    neg_inf_value=None,
):
    """Fill the banded DP for a batch of pairs.

    tables_dev / batch_dev are dicts of jnp arrays (see `device_tables` /
    `device_batch`).  Returns dict with 'score' [B] (the Viterbi or Forward
    end score) and, if return_matrices, 'mat'/'ins'/'del' [B, Ly+1, W]
    (row 0 = all -inf virtual row, matching the reference's storage rows).
    """
    combine = _max_combine if mode == "viterbi" else _lse_combine

    if "seg_d_lo" in batch_dev:
        raise ValueError(
            "dp_fill cannot consume lane-packed strip batches "
            "(PairBatch.build_packed); use PairBatch.build for the XLA "
            "engine"
        )

    x_tok = batch_dev["x_tok"]
    x_len = batch_dev["x_len"]
    y_tok = batch_dev["y_tok"]
    y_match_kmer = batch_dev["y_match_kmer"]
    ik_pad = batch_dev["y_indel_kmer_pad"]
    y_qual = batch_dev["y_qual"]
    y_has_qual = batch_dev["y_has_qual"]
    y_len = batch_dev["y_len"]
    d_lo = batch_dev["d_lo"]
    member = batch_dev["member"]

    B, W = member.shape
    Ly = y_tok.shape[1]
    # neg_inf_value: a finite stand-in (e.g. -1e30) keeps the fill
    # differentiable — jax.grad through -inf arithmetic yields NaNs
    neg_inf = jnp.array(
        NEG_INF if neg_inf_value is None else neg_inf_value, dtype=dtype
    )

    match_score = tables_dev["match_score"].astype(dtype)
    match_score_noq = tables_dev["match_score_noq"].astype(dtype)
    insert_score = tables_dev["insert_score"].astype(dtype)
    insert_score_noq = tables_dev["insert_score_noq"].astype(dtype)
    m2m_t = tables_dev["m2m"].astype(dtype)
    m2i_t = tables_dev["m2i"].astype(dtype)
    m2d_t = tables_dev["m2d"].astype(dtype)
    m2e_t = tables_dev["m2e"].astype(dtype)
    d2d = tables_dev["d2d"].astype(dtype)
    d2m = tables_dev["d2m"].astype(dtype)
    i2i = tables_dev["i2i"].astype(dtype)
    i2m = tables_dev["i2m"].astype(dtype)

    lane = jnp.arange(W, dtype=jnp.int32)[None, :]  # [1, W]

    def shift_hi(v):  # lane w reads lane w+1
        return jnp.concatenate([v[:, 1:], jnp.full((B, 1), neg_inf, dtype)], axis=1)

    def shift_lo(v):  # lane w reads lane w-1
        return jnp.concatenate([jnp.full((B, 1), neg_inf, dtype), v[:, :-1]], axis=1)

    def row_step(carry, j):
        mat_p, ins_p, del_p, end = carry

        ik_prev = ik_pad[:, j - 1]  # yIndelKmer[j-1] (dummy 0 at j=1)
        ik_cur = ik_pad[:, j]
        m2m_j = m2m_t[ik_prev][:, None]
        m2i_j = m2i_t[ik_prev][:, None]
        m2d_j = m2d_t[ik_cur][:, None]
        m2e_j = m2e_t[ik_cur][:, None]

        ykm = y_match_kmer[:, j - 1]
        yq = y_qual[:, j - 1]
        yt = y_tok[:, j - 1]
        # [B, 4]: emission scores for the 4 possible ref symbols in this row
        mrow_q = match_score[:, ykm, yq].T
        mrow_noq = match_score_noq[:, ykm].T
        mrow = jnp.where(y_has_qual[:, None], mrow_q, mrow_noq)
        ins_emit = jnp.where(
            y_has_qual, insert_score[yt, yq], insert_score_noq[yt]
        )[:, None]

        # lane -> ref offset (i-1); validity
        idx = d_lo[:, None] + (j - 1) + lane  # [B, W]
        valid = member & (idx >= 0) & (idx < x_len[:, None]) & (j <= y_len)[:, None]

        xtok_lane = jnp.take_along_axis(
            x_tok, jnp.clip(idx, 0, x_tok.shape[1] - 1), axis=1
        )
        emit = jnp.take_along_axis(mrow, xtok_lane, axis=1)

        # match state: all sources on the same lane of the previous row
        mat_c = combine(
            combine(mat_p + m2m_j, del_p + d2m), ins_p + i2m
        )
        start_ok = (j == 1) & (local | (idx == 0))
        mat_c = combine(mat_c, jnp.where(start_ok, jnp.zeros((), dtype), neg_inf))
        mat_c = jnp.where(valid, mat_c + emit, neg_inf)

        # insert state: sources on lane w+1 of the previous row
        ins_c = ins_emit + combine(shift_hi(ins_p) + i2i, shift_hi(mat_p) + m2i_j)
        ins_c = jnp.where(valid, ins_c, neg_inf)

        # delete state: in-row linear recurrence over lanes.  The f64
        # Viterbi parity path must replicate the reference's sequential
        # lane-order rounding exactly (tie-class traceback parity); the
        # f32 production path keeps the log-depth associative scan.
        b_vec = jnp.where(valid, shift_lo(mat_c) + m2d_j, neg_inf)
        c_vec = jnp.where(valid, d2d, neg_inf)
        recurrence = (
            _linear_recurrence_seq
            if mode == "viterbi" and np.dtype(dtype) == np.float64
            else _linear_recurrence
        )
        del_c = jnp.where(valid, recurrence(combine, c_vec, b_vec), neg_inf)

        # end contribution fires only on each pair's final row
        end_ok = valid & (local | (idx == x_len[:, None] - 1))
        row_end = jnp.where(end_ok, mat_c + m2e_j, neg_inf)
        if mode == "viterbi":
            contrib = jnp.max(row_end, axis=1)
        else:
            contrib = jax.nn.logsumexp(row_end, axis=1)
        end = combine(end, jnp.where(j == y_len, contrib, neg_inf))

        return (mat_c, ins_c, del_c, end), (
            (mat_c, ins_c, del_c) if return_matrices else None
        )

    init = (
        jnp.full((B, W), neg_inf, dtype),
        jnp.full((B, W), neg_inf, dtype),
        jnp.full((B, W), neg_inf, dtype),
        jnp.full((B,), neg_inf, dtype),
    )
    (mat_f, ins_f, del_f, end), ys = jax.lax.scan(
        row_step, init, jnp.arange(1, Ly + 1, dtype=jnp.int32)
    )
    out = {"score": end}
    if return_matrices:
        zero_row = jnp.full((B, 1, W), neg_inf, dtype)
        for name, stacked in zip(("mat", "ins", "del"), ys):
            # ys rows are [Ly, B, W]; prepend the virtual j=0 row
            out[name] = jnp.concatenate(
                [zero_row, jnp.moveaxis(stacked, 0, 1)], axis=1
            )
    return out


def device_tables(tables: ScoreTables) -> dict:
    return {
        "match_score": jnp.asarray(tables.match_score),
        "match_score_noq": jnp.asarray(tables.match_score_noq),
        "insert_score": jnp.asarray(tables.insert_score),
        "insert_score_noq": jnp.asarray(tables.insert_score_noq),
        "m2m": jnp.asarray(tables.m2m),
        "m2i": jnp.asarray(tables.m2i),
        "m2d": jnp.asarray(tables.m2d),
        "m2e": jnp.asarray(tables.m2e),
        "d2d": jnp.asarray(tables.d2d),
        "d2m": jnp.asarray(tables.d2m),
        "i2i": jnp.asarray(tables.i2i),
        "i2m": jnp.asarray(tables.i2m),
    }


def _narrow_int(a: np.ndarray, bound: int):
    """Transfer large index arrays in the narrowest dtype that holds
    [0, bound): host-to-device bytes shrink 4x for tokens and qualities,
    and every consumer widens before arithmetic."""
    if bound <= 127:
        return jnp.asarray(np.asarray(a, dtype=np.int8))
    if bound <= 32767:
        return jnp.asarray(np.asarray(a, dtype=np.int16))
    return jnp.asarray(a)


def device_batch(batch: PairBatch) -> dict:
    out = {
        "x_tok": _narrow_int(batch.x_tok, 4),
        "x_len": jnp.asarray(batch.x_len),
        "y_tok": _narrow_int(batch.y_tok, 4),
        "y_match_kmer": _narrow_int(
            batch.y_match_kmer, batch.match_kmer_bound
        ),
        "y_indel_kmer_pad": _narrow_int(
            batch.y_indel_kmer_pad, batch.indel_kmer_bound
        ),
        "y_qual": _narrow_int(batch.y_qual, 94),
        "y_has_qual": jnp.asarray(batch.y_has_qual),
        "y_len": jnp.asarray(batch.y_len),
        "d_lo": jnp.asarray(batch.d_lo),
        "member": jnp.asarray(batch.member),
    }
    if batch.seg_d_lo is not None:
        out["seg_d_lo"] = jnp.asarray(batch.seg_d_lo)
        out["seg_start"] = jnp.asarray(batch.seg_start)
        out["seg_width"] = jnp.asarray(batch.seg_width)
    return out


def _narrow_int_np(a: np.ndarray, bound: int) -> np.ndarray:
    if bound <= 127:
        return np.asarray(a, dtype=np.int8)
    if bound <= 32767:
        return np.asarray(a, dtype=np.int16)
    return np.asarray(a)


def host_batch(batch: PairBatch) -> dict:
    """device_batch's numpy twin: the same keys and narrowed dtypes, but
    left on the host — used by the mesh pipelines to stack several chunk
    batches into one [D, ...] global-array transfer instead of moving
    each chunk to the device only to pull it back for stacking."""
    out = {
        "x_tok": _narrow_int_np(batch.x_tok, 4),
        "x_len": np.asarray(batch.x_len),
        "y_tok": _narrow_int_np(batch.y_tok, 4),
        "y_match_kmer": _narrow_int_np(
            batch.y_match_kmer, batch.match_kmer_bound
        ),
        "y_indel_kmer_pad": _narrow_int_np(
            batch.y_indel_kmer_pad, batch.indel_kmer_bound
        ),
        "y_qual": _narrow_int_np(batch.y_qual, 94),
        "y_has_qual": np.asarray(batch.y_has_qual),
        "y_len": np.asarray(batch.y_len),
        "d_lo": np.asarray(batch.d_lo),
        "member": np.asarray(batch.member),
    }
    if batch.seg_d_lo is not None:
        out["seg_d_lo"] = np.asarray(batch.seg_d_lo)
        out["seg_start"] = np.asarray(batch.seg_start)
        out["seg_width"] = np.asarray(batch.seg_width)
    return out
