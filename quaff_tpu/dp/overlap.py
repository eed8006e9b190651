"""Read-vs-read overlap model: derived pair-emission tables + banded Viterbi.

Reimplements the reference's QuaffOverlapScores / QuaffOverlapViterbiMatrix
(src/qoverlap.cpp:9-160).  The overlap model marginalises the unknown
reference out of two read-generating transducers:

  matchMinusInsert[i_kmer, j_kmer, qi, qj] =
      log sum_r refBase[r] * match(r -> i, qi) * match(r* -> j, qj)
      - insert(i, qi) - insert(j, qj)

(r* is the complement when the second read is a reverse-strand copy), and
approximates the transducer-intersection gap structure with averaged
gap-open/extend/adjacent probabilities (qoverlap.cpp:22-48).  The table is
built once per (params, strand) — hoisted out of the per-pair loop, fixing
a known inefficiency of the reference (qoverlap.cpp:77-79 rebuilds per
task).

NOTE on gap scores: the reference's accessor layer swaps i2m<->i2i and
d2m<->d2i relative to the constructor's fields (qoverlap.h:46-51).  The
*effective* values those accessors produce are what its golden outputs
encode, so this implementation stores the effective values directly:
  i2m_eff = d2d_eff = log(gapExtend)
  i2i_eff = d2i_eff = log(1-gapExtend) + log(1-gapAdjacent)
  i2d_eff = log(1-gapExtend) + log(gapAdjacent)
  d2m_eff = log(1-gapExtend) + log(gapAdjacent)

The banded fill mirrors dp/engine.py.  The Viterbi recursion mixes max
(path choice) with log-sum-exp *inside* the gap states (merging degenerate
insert/delete orderings, qoverlap.cpp:143-149); the resulting in-row
recurrence  del[w] = max(lse(del[w-1]+c, k[w]), b[w])  is evaluated with an
associative scan over affine-max maps in linear space, carried in log
space as triples (a, k, b) with composition
  (a1,k1,b1) . (a2,k2,b2) = (a1+a2, lse(k1+a2, k2), max(lse(b1+a2, k2), b2)).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..alphabet import ALPHABET_SIZE, QUAL_SCORE_RANGE
from ..model.params import QuaffParams
from .scores import ScoreTables
from .engine import NEG_INF, two_sum


@dataclass
class OverlapScoreTables:
    match_kmer_len: int
    indel_kmer_len: int
    y_complemented: bool
    # emissions (log): pair tables conditioned on available quality scores
    pair_qq: np.ndarray  # [Km, Km, Q, Q]
    pair_xq: np.ndarray  # [Km, Km, Q]
    pair_yq: np.ndarray  # [Km, Km, Q]
    pair_nn: np.ndarray  # [Km, Km]
    insert_score: np.ndarray  # [4, Q]  (x and y share the insert model)
    insert_score_noq: np.ndarray  # [4]
    # transitions (log, effective values; see module docstring)
    m2m: np.ndarray  # [Ki, Ki]
    m2i: np.ndarray  # [Ki, Ki]
    m2d: np.ndarray  # [Ki, Ki]
    i2m_eff: float
    i2i_eff: float
    i2d_eff: float
    d2m_eff: float
    d2i_eff: float
    d2d_eff: float

    @classmethod
    def from_params(
        cls, qp: QuaffParams, y_complemented: bool, tables: ScoreTables | None = None
    ) -> "OverlapScoreTables":
        if tables is None:
            tables = ScoreTables.from_params(qp)
        ki = qp.num_indel_kmers
        km = qp.num_match_kmers

        # gap structure (qoverlap.cpp:22-48)
        ri = qp.begin_insert
        rd = (1 - qp.begin_insert) * qp.begin_delete
        gap_open = ri + rd  # [Ki]
        p_gap_is_insert = ri / gap_open
        gap_adjacent_k = p_gap_is_insert * ri + (1 - p_gap_is_insert) * gap_open / (
            1 - qp.extend_delete * (1 - gap_open)
        )
        m2m = np.log(1 - gap_open)[:, None] + np.log(1 - gap_open)[None, :]
        m2i = np.broadcast_to(np.log(gap_open)[:, None], (ki, ki)).copy()
        m2d = np.log(1 - gap_open)[:, None] + np.log(gap_open)[None, :]

        pgi = float(np.mean(p_gap_is_insert))
        mean_gap_len = pgi / qp.extend_insert + (1 - pgi) / qp.extend_delete
        gap_extend = 1.0 / mean_gap_len
        gap_adjacent = float(np.mean(gap_adjacent_k))

        log_ge = np.log(gap_extend)
        log_1ge = np.log(1 - gap_extend)
        log_ga = np.log(gap_adjacent)
        log_1ga = np.log(1 - gap_adjacent)

        # pair emission tables (qoverlap.cpp:53-74), vectorised over
        # (kmer_i, kmer_j, qi, qj) with the reference marginalised out.
        # The log-sum-exp here reproduces the reference's lookup-table
        # semantics (logsumexp.cpp:84-103): contributions more than 10 nats
        # below the running max are dropped.  Golden overlap scores encode
        # that truncation (~2.5e-6/column), so exact lse would drift by
        # ~0.02 over a 6.6kb alignment.
        ms = tables.match_score  # [4, Km, Q]
        log_rb = np.log(qp.ref_base)  # [4]
        r_idx = np.arange(ALPHABET_SIZE)
        y_r = (ALPHABET_SIZE - 1 - r_idx) if y_complemented else r_idx
        # sequential truncated lse over r, in the reference's order
        m_pair = np.full((km, km, QUAL_SCORE_RANGE, QUAL_SCORE_RANGE), -np.inf)
        for r in range(ALPHABET_SIZE):
            term = (
                log_rb[r]
                + ms[r][:, None, :, None]
                + ms[y_r[r]][None, :, None, :]
            )
            m_pair = _ref_lse(m_pair, term)

        ins = tables.insert_score  # [4, Q]
        ins_n = tables.insert_score_noq  # [4]
        i_sfx = np.arange(km) % ALPHABET_SIZE
        xi = ins[i_sfx]  # [Km, Q]
        xn = ins_n[i_sfx]  # [Km]

        pair_qq = (
            m_pair - xi[:, None, :, None] - xi[None, :, None, :]
        )
        # marginal tables: the reference accumulates these with sequential
        # truncated lse in (qi outer, qj inner) order (qoverlap.cpp:59-71).
        # Each output slot's accumulation order is preserved exactly; the
        # independent slots are batched per step (and the whole ordered
        # chain runs in C when the native library is built — thousands of
        # tiny numpy dispatches otherwise dominate the table build).
        Q = QUAL_SCORE_RANGE
        # XQual[ik]: per slot ik, sequential over jk
        t_xq = np.ascontiguousarray(
            (m_pair - xi[:, None, :, None] - xn[None, :, None, None])
            .transpose(3, 0, 1, 2)  # [jk, km, km, ik]
        )
        pair_xq = _ref_lse_chain(
            np.full((km, km, Q), -np.inf), t_xq
        )
        # YQual[jk]: per slot jk, sequential over ik
        t_yq = np.ascontiguousarray(
            (m_pair - xn[:, None, None, None] - xi[None, :, None, :])
            .transpose(2, 0, 1, 3)  # [ik, km, km, jk]
        )
        pair_yq = _ref_lse_chain(
            np.full((km, km, Q), -np.inf), t_yq
        )
        # PairProb: one slot, sequential over (ik, jk) lexicographic
        t_nn = np.ascontiguousarray(
            (m_pair - xn[:, None, None, None] - xn[None, :, None, None])
            .transpose(2, 3, 0, 1)  # [ik, jk, km, km]
            .reshape(Q * Q, km, km)
        )
        pair_nn = _ref_lse_chain(np.full((km, km), -np.inf), t_nn)

        return cls(
            match_kmer_len=qp.match_kmer_len,
            indel_kmer_len=qp.indel_kmer_len,
            y_complemented=y_complemented,
            pair_qq=pair_qq,
            pair_xq=pair_xq,
            pair_yq=pair_yq,
            pair_nn=pair_nn,
            insert_score=tables.insert_score,
            insert_score_noq=tables.insert_score_noq,
            m2m=m2m,
            m2i=m2i,
            m2d=m2d,
            i2m_eff=float(log_ge),
            i2i_eff=float(log_1ge + log_1ga),
            i2d_eff=float(log_1ge + log_ga),
            d2m_eff=float(log_1ge + log_ga),
            d2i_eff=float(log_1ge + log_1ga),
            d2d_eff=float(log_ge),
        )


def _ref_lse_chain(acc: np.ndarray, terms: np.ndarray) -> np.ndarray:
    """Ordered _ref_lse accumulation: acc = ref_lse(acc, terms[t]) for
    t ascending.  terms is [n_steps, *acc.shape].  Runs in C when the
    native library is built (native/quaffio.cpp qref_lse_chain —
    bit-identical float ops), else loops in numpy."""
    acc = np.ascontiguousarray(acc, np.float64)
    from ..native import ref_lse_chain_native

    if ref_lse_chain_native(acc, terms):
        return acc
    for t in range(terms.shape[0]):
        acc = _ref_lse(acc, terms[t])
    return acc


def _ref_lse(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The reference's lookup-table log-sum-exp semantics
    (logsumexp.cpp:34-103): exact log1p(exp(-diff)) correction for
    diff < 10, but contributions >= 10 nats below the max are DROPPED
    (the table covers [0, 10) only and returns 0 beyond it).  Golden
    overlap scores depend on this truncation."""
    m = np.maximum(a, b)
    with np.errstate(invalid="ignore"):
        d = np.abs(a - b)
        corr = np.log1p(np.exp(-np.minimum(d, 50.0)))
    out = np.where((d >= 10.0) | ~np.isfinite(d), m, m + corr)
    return np.where(np.isneginf(a) & np.isneginf(b), a, out)


def overlap_device_tables(t: OverlapScoreTables) -> dict:
    return {
        "pair_qq": jnp.asarray(t.pair_qq),
        "pair_xq": jnp.asarray(t.pair_xq),
        "pair_yq": jnp.asarray(t.pair_yq),
        "pair_nn": jnp.asarray(t.pair_nn),
        "insert_score": jnp.asarray(t.insert_score),
        "insert_score_noq": jnp.asarray(t.insert_score_noq),
        "m2m": jnp.asarray(t.m2m),
        "m2i": jnp.asarray(t.m2i),
        "m2d": jnp.asarray(t.m2d),
        "trans": jnp.asarray(
            [t.i2m_eff, t.i2i_eff, t.i2d_eff, t.d2m_eff, t.d2i_eff, t.d2d_eff]
        ),
    }


def overlap_bytes_per_row(width: int, rows: int, x_len: int) -> int:
    """Device bytes one batch row (an envelope strip) takes in a
    score-only overlap_fill: its x-side and y-side context arrays and
    the [W] row states the scan carries and gathers into."""
    return 4 * (4 * x_len + 5 * rows + 16 * width)


def _mixed_recurrence(c_vec, k_vec, b_vec, neg_inf):
    """x[w] = max(lse(x[w-1] + c[w], k[w]), b[w]) with x[-1] = -inf.

    Associative scan over affine-max maps X -> max(C*X + K, B) in linear
    space, carried as log-space triples (a, k, b).
    """

    def op(left, right):
        a1, k1, b1 = left
        a2, k2, b2 = right
        return (
            a1 + a2,
            jnp.logaddexp(k1 + a2, k2),
            jnp.maximum(jnp.logaddexp(b1 + a2, k2), b2),
        )

    _, k, b = jax.lax.associative_scan(op, (c_vec, k_vec, b_vec), axis=-1)
    return jnp.maximum(k, b)


@partial(jax.jit, static_argnames=("return_matrices", "dtype"))
def overlap_fill(
    tdev: dict,
    batch_dev: dict,
    return_matrices: bool = False,
    dtype=jnp.float32,
):
    """Banded overlap Viterbi fill (qoverlap.cpp:122-160).

    batch_dev extends the standard batch dict with x-side arrays:
      x_match_kmer [B, Lx], x_indel_kmer_pad [B, Lx+1], x_qual [B, Lx],
      x_has_qual [B], and precomputed x_insert_score + y_insert_score [B].
    Returns 'score' [B] (= end + full-sequence insert scores) and
    optionally the three matrices.

    Optional "j_off" [B] shifts each pair's row window: batch row r
    holds true row j = j_off + r + 1, with the y-side arrays pre-shifted
    by the caller (OverlapBatch row_off).  A strip whose member
    diagonals are all >= d only has valid cells from row max(1, 1-d_max)
    to min(y_len, x_len-d_min), so trimming the dead rows (exact: they
    are entirely outside the envelope) nearly halves the fill for
    overlap strips on distant diagonals.
    """
    x_tok = batch_dev["x_tok"]
    x_len = batch_dev["x_len"]
    y_tok = batch_dev["y_tok"]
    y_match_kmer = batch_dev["y_match_kmer"]
    ik_pad_y = batch_dev["y_indel_kmer_pad"]
    y_qual = batch_dev["y_qual"]
    y_has_qual = batch_dev["y_has_qual"]
    y_len = batch_dev["y_len"]
    d_lo = batch_dev["d_lo"]
    member = batch_dev["member"]
    x_match_kmer = batch_dev["x_match_kmer"]
    ik_pad_x = batch_dev["x_indel_kmer_pad"]
    x_qual = batch_dev["x_qual"]
    x_has_qual = batch_dev["x_has_qual"]

    B, W = member.shape
    Ly = y_tok.shape[1]
    neg_inf = jnp.array(NEG_INF, dtype=dtype)
    j_off = batch_dev.get("j_off")
    if j_off is None:
        j_off = jnp.zeros((B,), jnp.int32)
    j_off_c = j_off.astype(jnp.int32)[:, None]  # [B, 1]

    pair_qq = tdev["pair_qq"].astype(dtype)
    pair_xq = tdev["pair_xq"].astype(dtype)
    pair_yq = tdev["pair_yq"].astype(dtype)
    pair_nn = tdev["pair_nn"].astype(dtype)
    m2m_t = tdev["m2m"].astype(dtype)
    m2i_t = tdev["m2i"].astype(dtype)
    m2d_t = tdev["m2d"].astype(dtype)
    i2m_e, i2i_e, i2d_e, d2m_e, d2i_e, d2d_e = [
        tdev["trans"][i].astype(dtype) for i in range(6)
    ]

    lane = jnp.arange(W, dtype=jnp.int32)[None, :]

    def shift_hi(v):
        return jnp.concatenate([v[:, 1:], jnp.full((B, 1), neg_inf, dtype)], axis=1)

    def shift_lo(v):
        return jnp.concatenate([jnp.full((B, 1), neg_inf, dtype), v[:, :-1]], axis=1)

    def gather_x(arr, idx):
        return jnp.take_along_axis(arr, jnp.clip(idx, 0, arr.shape[1] - 1), axis=1)

    # Score-only fills rebase every row: the row's best match/insert state
    # becomes 0 and the pair's offset (two floats, TwoSum) grows by it, so
    # f32 rounding acts on per-row magnitudes rather than on the whole
    # path's score.  A free start (absolute 0) is -offset in these terms.
    # Fills that return matrices keep absolute values for the traceback.
    rebase = not return_matrices

    def row_step(carry, j):
        mat_p, ins_p, del_p, end, end_lo, off_hi, off_lo = carry

        jt = j_off_c + j  # true row number per pair, [B, 1]
        idx = d_lo[:, None] + (jt - 1) + lane  # i-1 per lane
        valid = member & (idx >= 0) & (idx < x_len[:, None]) & (jt <= y_len[:, None])

        # per-lane x context
        xkm = gather_x(x_match_kmer, idx)
        xq = gather_x(x_qual, idx)
        # x indel kmer at padded position i -> index i in ik_pad_x; also i-1
        xik_i = gather_x(ik_pad_x, idx + 1)  # xIndelKmer[i]
        xik_im1 = gather_x(ik_pad_x, idx)  # xIndelKmer[i-1]

        ykm = y_match_kmer[:, j - 1][:, None]
        yq = y_qual[:, j - 1][:, None]
        yik_j = ik_pad_y[:, j][:, None]
        yik_jm1 = ik_pad_y[:, j - 1][:, None]

        # emission: dispatch on which side has quality scores
        e_qq = pair_qq[xkm, ykm, xq, yq]
        e_xq = pair_xq[xkm, ykm, xq]
        e_yq = pair_yq[xkm, ykm, yq]
        e_nn = pair_nn[xkm, ykm]
        hq_x = x_has_qual[:, None]
        hq_y = y_has_qual[:, None]
        emit = jnp.where(
            hq_x, jnp.where(hq_y, e_qq, e_xq), jnp.where(hq_y, e_yq, e_nn)
        )

        # mat: sources (i-1, j-1) on the same lane of the previous row
        mat_c = jnp.maximum(
            jnp.maximum(
                mat_p + m2m_t[xik_im1, yik_jm1], del_p + d2m_e
            ),
            ins_p + i2m_e,
        )
        start_ok = (jt == 1) | (idx == 0)  # overlap: both ends free
        start = -(off_hi + off_lo)[:, None] if rebase else jnp.zeros((), dtype)
        mat_c = jnp.maximum(mat_c, jnp.where(start_ok, start, neg_inf))
        mat_c = jnp.where(valid, mat_c + emit, neg_inf)

        # ins: sources on lane w+1 of the previous row; degenerate D->I
        # ordering merged with lse (qoverlap.cpp:143-145)
        # m2iScore(i, j-1): x context at i (current cell's i), y at j-1
        ins_c = jnp.maximum(
            jnp.logaddexp(shift_hi(ins_p) + i2i_e, shift_hi(del_p) + d2i_e),
            shift_hi(mat_p) + m2i_t[xik_i, yik_jm1],
        )
        ins_c = jnp.where(valid, ins_c, neg_inf)
        if rebase:
            top = jnp.max(jnp.maximum(mat_c, ins_c), axis=1)
            top = jnp.where(jnp.isfinite(top), top, 0.0)
            mat_c = mat_c - top[:, None]
            ins_c = ins_c - top[:, None]
            hi, err = two_sum(off_hi, top)
            off_hi, off_lo = hi, off_lo + err

        # del: mixed max/lse in-row recurrence over lanes
        c_vec = jnp.where(valid, d2d_e, neg_inf)
        k_vec = jnp.where(valid, shift_lo(ins_c) + d2i_e, neg_inf)
        b_vec = jnp.where(
            valid, shift_lo(mat_c) + m2d_t[xik_im1, yik_j], neg_inf
        )
        del_c = jnp.where(valid, _mixed_recurrence(c_vec, k_vec, b_vec, neg_inf), neg_inf)

        # end: free at either sequence's end (qoverlap.cpp:151-153)
        end_ok = valid & ((jt == y_len[:, None]) | (idx == x_len[:, None] - 1))
        row_end = jnp.max(jnp.where(end_ok, mat_c, neg_inf), axis=1)
        if rebase:
            # the best end so far, as two floats (end, end_lo)
            cand_lo = off_lo + row_end
            better = (off_hi - end) + (cand_lo - end_lo) > 0
            better = better | (jnp.isfinite(row_end) & ~jnp.isfinite(end))
            end = jnp.where(better, off_hi, end)
            end_lo = jnp.where(better, cand_lo, end_lo)
        else:
            end = jnp.maximum(end, row_end)

        return (mat_c, ins_c, del_c, end, end_lo, off_hi, off_lo), (
            (mat_c, ins_c, del_c) if return_matrices else None
        )

    init = tuple(
        jnp.full(s, neg_inf, dtype) for s in [(B, W), (B, W), (B, W), (B,)]
    ) + tuple(jnp.zeros((B,), dtype) for _ in range(3))
    (_, _, _, end, end_lo, _, _), ys = jax.lax.scan(
        row_step, init, jnp.arange(1, Ly + 1, dtype=jnp.int32)
    )
    if rebase:
        end = jnp.where(jnp.isfinite(end_lo), end + end_lo, neg_inf)

    out = {
        "score": end + batch_dev["x_insert_score"].astype(dtype)
        + batch_dev["y_insert_score"].astype(dtype),
        "end": end,
    }
    if return_matrices:
        zero_row = jnp.full((B, 1, W), neg_inf, dtype)
        for name, stacked in zip(("mat", "ins", "del"), ys):
            out[name] = jnp.concatenate(
                [zero_row, jnp.moveaxis(stacked, 0, 1)], axis=1
            )
    return out
