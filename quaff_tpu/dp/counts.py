"""Forward-Backward with in-pass expected-count accumulation.

Batched reimplementation of QuaffBackwardMatrix (src/qmodel.cpp:1393-1510):
the forward fill stores its banded rows on device; the backward fill scans
rows in reverse, carrying the next row's backward state, and emits per-row
posterior transition/emission count contributions.  Per-cell scatter
(the reference's matchCount/insertCount increments) is restructured as:
per-row reductions over the band (ref-symbol axis), followed by a
post-scan segment sum over rows keyed by (read k-mer, quality).

Backward recursion in band coordinates (lane w <-> diagonal d, cell
i = d + j):
  back_del[j][w] = lse(d2m + me[j+1][w] + back_mat[j+1][w],
                       d2d + back_del[j][w+1])          (in-row, reverse)
  back_mat[j][w] = lse(end-term if j==yLen,
                       m2m(j) + me[j+1][w] + back_mat[j+1][w],
                       m2i(j) + ie(j+1)   + back_ins[j+1][w-1],
                       m2d(j) + back_del[j][w+1])
  back_ins[j][w] = lse(i2m + me[j+1][w] + back_mat[j+1][w],
                       i2i + ie(j+1)   + back_ins[j+1][w-1])
Counts: exp(fwd_src + trans (+emit) + back_dest - fwd_result), matching
transCount (qmodel.cpp:1505-1510).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..alphabet import QUAL_SCORE_RANGE
from .engine import NEG_INF, _linear_recurrence, _lse_combine, two_sum

_HIGHEST = jax.lax.Precision.HIGHEST

# Device bytes per banded DP cell of an f32 dp_forward_backward call: the
# stored forward rows (3 states) and the backward scan's shifted and
# reversed views of them.  XLA's memory analysis on an H100 gave 24.0
# (64.6 GB of temporaries for 256 pairs x 6,605 rows x 1,592 lanes).
BYTES_PER_CELL = 24


def _reverse_linear_recurrence(combine, c_vec, b_vec):
    """x[w] = combine(x[w+1] + c[w], b[w]) with x[W] = -inf."""
    x = _linear_recurrence(combine, c_vec[..., ::-1], b_vec[..., ::-1])
    return x[..., ::-1]


@partial(
    jax.jit,
    static_argnames=(
        "local", "dtype", "num_match_kmers", "num_indel_kmers", "return_post",
    ),
)
def dp_forward_backward(
    tables_dev: dict,
    batch_dev: dict,
    local: bool = True,
    dtype=jnp.float32,
    num_match_kmers: int = 4,
    num_indel_kmers: int = 1,
    return_post: bool = False,
):
    """Returns per-pair forward score, backward score, and expected counts.

    Output dict:
      fwd_score [B], back_score [B]
      match_counts [B, 4, Km, Q], insert_counts [B, 4, Q]
      m2m, m2i, m2d, m2e  [B, Ki]
      i2i, i2m, d2d, d2m  [B]
    Pairs whose forward score is -inf produce all-zero counts.
    """
    lse = _lse_combine

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
    neg_inf = jnp.array(NEG_INF, dtype=dtype)

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

    lane = jnp.arange(W, dtype=jnp.int32)[None, :]

    def shift_hi(v):  # lane w reads lane w+1
        return jnp.concatenate([v[:, 1:], jnp.full((B, 1), neg_inf, dtype)], axis=1)

    def shift_lo(v):  # lane w reads lane w-1
        return jnp.concatenate([jnp.full((B, 1), neg_inf, dtype), v[:, :-1]], axis=1)

    def row_emissions(j):
        ykm = y_match_kmer[:, j - 1]
        yq = y_qual[:, j - 1]
        yt = y_tok[:, j - 1]
        mrow = jnp.where(
            y_has_qual[:, None], match_score[:, ykm, yq].T, match_score_noq[:, ykm].T
        )
        ie = jnp.where(y_has_qual, insert_score[yt, yq], insert_score_noq[yt])
        idx = d_lo[:, None] + (j - 1) + lane
        valid = member & (idx >= 0) & (idx < x_len[:, None]) & (j <= y_len)[:, None]
        xtok_lane = jnp.take_along_axis(x_tok, jnp.clip(idx, 0, x_tok.shape[1] - 1), axis=1)
        me = jnp.take_along_axis(mrow, xtok_lane, axis=1)
        return me, ie, idx, valid, xtok_lane

    # ---------------- forward pass, storing rows -------------------------
    # Every row is rebased: its best match/insert state becomes 0 and the
    # pair's offset (the sum of the rebases, carried as two floats by
    # TwoSum) grows by it.  Rounding then acts on per-row magnitudes, not
    # on the whole path's score — in f32 the unrebased fill drifts by
    # about a nat over a 6,604-row read, which the posterior weights
    # exp(fwd + back - total) would carry into every count.

    def rebase(off_hi, off_lo, *rows):
        top = jnp.max(jnp.maximum(rows[0], rows[1]), axis=1)
        for r in rows[2:]:
            top = jnp.maximum(top, jnp.max(r, axis=1))
        top = jnp.where(jnp.isfinite(top), top, 0.0)
        hi, err = two_sum(off_hi, top)
        return [r - top[:, None] for r in rows], hi, off_lo + err

    def fwd_step(carry, j):
        mat_p, ins_p, del_p, end_rel, end_hi, end_lo, off_hi, off_lo = carry
        ik_prev = ik_pad[:, j - 1]
        ik_cur = ik_pad[:, j]
        me, ie, idx, valid, _ = row_emissions(j)
        mat_c = lse(lse(mat_p + m2m_t[ik_prev][:, None], del_p + d2m), ins_p + i2m)
        start_ok = (j == 1) & (local | (idx == 0))
        mat_c = lse(mat_c, jnp.where(start_ok, jnp.zeros((), dtype), neg_inf))
        mat_c = jnp.where(valid, mat_c + me, neg_inf)
        ins_c = ie[:, None] + lse(shift_hi(ins_p) + i2i, shift_hi(mat_p) + m2i_t[ik_prev][:, None])
        ins_c = jnp.where(valid, ins_c, neg_inf)
        (mat_c, ins_c), off_hi, off_lo = rebase(off_hi, off_lo, mat_c, ins_c)
        b_vec = jnp.where(valid, shift_lo(mat_c) + m2d_t[ik_cur][:, None], neg_inf)
        c_vec = jnp.where(valid, d2d, neg_inf)
        del_c = jnp.where(valid, _linear_recurrence(lse, c_vec, b_vec), neg_inf)
        end_ok = valid & (local | (idx == x_len[:, None] - 1))
        contrib = jax.nn.logsumexp(
            jnp.where(end_ok, mat_c + m2e_t[ik_cur][:, None], neg_inf), axis=1
        )
        last = j == y_len
        end_rel = jnp.where(last, contrib, end_rel)
        end_hi = jnp.where(last, off_hi, end_hi)
        end_lo = jnp.where(last, off_lo, end_lo)
        return (mat_c, ins_c, del_c, end_rel, end_hi, end_lo, off_hi, off_lo), (
            mat_c, ins_c, del_c, off_hi, off_lo
        )

    init = tuple(jnp.full((B, W), neg_inf, dtype) for _ in range(3)) + (
        jnp.full((B,), neg_inf, dtype),
    ) + tuple(jnp.zeros((B,), dtype) for _ in range(4))
    (_, _, _, end_rel, end_hi, end_lo, _, _), fwd_rows = jax.lax.scan(
        fwd_step, init, jnp.arange(1, Ly + 1, dtype=jnp.int32)
    )
    fm_rows, fi_rows, fd_rows, fo_hi, fo_lo = fwd_rows
    # the total forward score as two floats: its end row's offset and the
    # end cell relative to it
    f_hi, f_lo = end_hi, end_lo + end_rel
    fwd_score = f_hi + f_lo
    # prepend virtual row 0 (all -inf, offset 0)
    zrow = jnp.full((1, B, W), neg_inf, dtype)
    fm = jnp.concatenate([zrow, fm_rows], axis=0)  # [Ly+1, B, W]
    fi = jnp.concatenate([zrow, fi_rows], axis=0)
    fd = jnp.concatenate([zrow, fd_rows], axis=0)
    z1 = jnp.zeros((1, B), dtype)
    fo_hi = jnp.concatenate([z1, fo_hi], axis=0)  # [Ly+1, B]
    fo_lo = jnp.concatenate([z1, fo_lo], axis=0)

    finite = jnp.isfinite(fwd_score)

    # ---------------- backward pass with counts --------------------------

    def back_step(carry, xs):
        bm_next, bi_next, bd_next, me_next, ie_next, b_hi, b_lo = carry
        (j, fm_cur, fi_cur, fd_cur, fm_prev, fi_prev, fd_prev,
         oc_hi, oc_lo, op_hi, op_lo) = xs
        ik_prev = ik_pad[:, j - 1]
        ik_cur = ik_pad[:, j]
        me_cur, ie_cur, idx, valid, xtok_lane = row_emissions(j)

        m2m_j = m2m_t[ik_cur][:, None]
        m2i_j = m2i_t[ik_cur][:, None]
        m2d_j = m2d_t[ik_cur][:, None]
        m2e_j = m2e_t[ik_cur][:, None]

        # back del (in-row reverse recurrence)
        from_match = me_next + bm_next  # contribution via (i+1, j+1), lane w
        b_vec = jnp.where(valid, d2m + from_match, neg_inf)
        c_vec = jnp.where(valid, d2d, neg_inf)
        bd_cur = jnp.where(valid, _reverse_linear_recurrence(lse, c_vec, b_vec), neg_inf)

        # back mat
        end_ok = valid & (local | (idx == x_len[:, None] - 1)) & (j == y_len)[:, None]
        bm_cur = lse(
            lse(
                jnp.where(end_ok, m2e_j, neg_inf),
                m2m_j + from_match,
            ),
            lse(
                m2i_j + ie_next[:, None] + shift_lo(bi_next),
                m2d_j + shift_hi(bd_cur),
            ),
        )
        bm_cur = jnp.where(valid, bm_cur, neg_inf)

        # back ins
        bi_cur = lse(i2m + from_match, i2i + ie_next[:, None] + shift_lo(bi_next))
        bi_cur = jnp.where(valid, bi_cur, neg_inf)
        # rebase the backward row as the forward rows were
        (bm_cur, bi_cur, bd_cur), b_hi, b_lo = rebase(
            b_hi, b_lo, bm_cur, bi_cur, bd_cur
        )

        # ---- posterior counts (transCount, qmodel.cpp:1505-1510) ----
        # each weight is exp(forward part + backward part - total); the
        # parts' offsets meet the total in two-float arithmetic, so the
        # exponent is exact to f32 at its own (small) magnitude
        def shift(a_hi, a_lo, b_hi, b_lo):
            """(a + b) - total per pair, [B, 1]."""
            s, e1 = two_sum(a_hi, b_hi)
            t, e2 = two_sum(s, -f_hi)
            return (t + (e1 + e2 + a_lo + b_lo - f_lo))[:, None]

        zero = jnp.zeros_like(b_hi)
        c_prev = shift(op_hi, op_lo, b_hi, b_lo)  # fwd row j-1, back row j
        c_cur = shift(oc_hi, oc_lo, b_hi, b_lo)  # fwd row j, back row j
        c_end = shift(oc_hi, oc_lo, zero, zero)  # fwd row j, the end

        def post(logw, c):
            return jnp.where(finite[:, None], jnp.exp(logw + c), 0.0)

        mm = m2m_t[ik_prev][:, None]
        mi = m2i_t[ik_prev][:, None]
        w_m2m = post(fm_prev + mm + me_cur + bm_cur, c_prev)
        w_d2m = post(fd_prev + d2m + me_cur + bm_cur, c_prev)
        w_i2m = post(fi_prev + i2m + me_cur + bm_cur, c_prev)
        start_ok = (j == 1) & (local | (idx == 0))
        # the start's forward part is 0, the offset of row 0
        w_s2m = jnp.where(start_ok, post(me_cur + bm_cur, c_prev), 0.0)
        mc = w_m2m + w_d2m + w_i2m + w_s2m

        w_m2i = post(shift_hi(fm_prev) + mi + ie_cur[:, None] + bi_cur, c_prev)
        w_i2i = post(shift_hi(fi_prev) + i2i + ie_cur[:, None] + bi_cur, c_prev)
        ic = w_m2i + w_i2i

        w_m2d = post(shift_lo(fm_cur) + m2d_j + bd_cur, c_cur)
        w_d2d = post(shift_lo(fd_cur) + d2d + bd_cur, c_cur)
        w_m2e = jnp.where(end_ok, post(fm_cur + m2e_j, c_end), 0.0)

        # start contribution to the backward result (only row 1)
        s_contrib = jax.nn.logsumexp(
            jnp.where(valid & (local | (idx == 0)), me_cur + bm_cur, neg_inf),
            axis=1,
        )
        s_contrib = jnp.where(j == 1, b_hi + (b_lo + s_contrib), neg_inf)

        # per-row reductions
        onehot_x = jax.nn.one_hot(xtok_lane, 4, dtype=dtype)  # [B, W, 4]
        mc4 = jnp.einsum("bw,bwa->ba", mc, onehot_x, precision=_HIGHEST)
        row_out = {
            "mc4": mc4,
            "ic": jnp.sum(ic, axis=1),
            "m2m": jnp.sum(w_m2m, axis=1),
            "m2i": jnp.sum(w_m2i, axis=1),
            "m2d": jnp.sum(w_m2d, axis=1),
            "m2e": jnp.sum(w_m2e, axis=1),
            "i2i": jnp.sum(w_i2i, axis=1),
            "i2m": jnp.sum(w_i2m, axis=1),
            "d2d": jnp.sum(w_d2d, axis=1),
            "d2m": jnp.sum(w_d2m, axis=1),
            "start": s_contrib,
        }
        if return_post:
            # per-cell posterior state probabilities for `-log postmatrix`
            # (QuaffForwardBackwardMatrix::postMatch/Insert/Delete,
            # qmodel.cpp:1778-1788)
            row_out["post_mat"] = post(fm_cur + bm_cur, c_cur)
            row_out["post_ins"] = post(fi_cur + bi_cur, c_cur)
            row_out["post_del"] = post(fd_cur + bd_cur, c_cur)
        return (bm_cur, bi_cur, bd_cur, me_cur, ie_cur, b_hi, b_lo), row_out

    init_b = (
        jnp.full((B, W), neg_inf, dtype),
        jnp.full((B, W), neg_inf, dtype),
        jnp.full((B, W), neg_inf, dtype),
        jnp.zeros((B, W), dtype),
        jnp.zeros((B,), dtype),
        jnp.zeros((B,), dtype),
        jnp.zeros((B,), dtype),
    )
    js = jnp.arange(1, Ly + 1, dtype=jnp.int32)
    xs = (js, fm[1:], fi[1:], fd[1:], fm[:-1], fi[:-1], fd[:-1],
          fo_hi[1:], fo_lo[1:], fo_hi[:-1], fo_lo[:-1])
    # reverse row order for the backward scan
    xs_rev = jax.tree_util.tree_map(lambda a: a[::-1], xs)
    _, rows = jax.lax.scan(back_step, init_b, xs_rev)
    # rows are stacked j = Ly..1; order is irrelevant for reductions except
    # back_score which is just the j=1 row (last element)
    back_score = rows["start"][-1]

    # ---------------- post-scan keyed reductions -------------------------
    # segment sums over (pair, key) ids: exact f32/f64 sums, without the
    # [B, Ly, keys] one-hot a matmul would need
    Q = QUAL_SCORE_RANGE
    Km = num_match_kmers
    Ki = num_indel_kmers

    def rows_of(name):  # per-row values back in j = 1..Ly order, [B, Ly, ...]
        return jnp.moveaxis(rows[name][::-1], 0, 1)

    row_valid = (jnp.arange(1, Ly + 1)[None, :] <= y_len[:, None]).astype(dtype)
    pair = jnp.arange(B, dtype=jnp.int32)[:, None]

    def keyed(vals, key, n_keys):
        """sum over rows l of vals[b, l, ...] into [B, n_keys, ...] by key[b, l]."""
        v = vals * row_valid.reshape(row_valid.shape + (1,) * (vals.ndim - 2))
        seg = (pair * n_keys + key.astype(jnp.int32)).reshape(-1)
        out = jax.ops.segment_sum(
            v.reshape((B * Ly,) + v.shape[2:]), seg, num_segments=B * n_keys
        )
        return out.reshape((B, n_keys) + v.shape[2:])

    kq_key = y_match_kmer.astype(jnp.int32) * Q + y_qual.astype(jnp.int32)
    match_counts = keyed(rows_of("mc4"), kq_key, Km * Q)  # [B, Km*Q, 4]
    match_counts = jnp.moveaxis(match_counts, 2, 1).reshape(B, 4, Km, Q)

    tq_key = y_tok.astype(jnp.int32) * Q + y_qual.astype(jnp.int32)
    insert_counts = keyed(rows_of("ic"), tq_key, 4 * Q).reshape(B, 4, Q)

    # transition counts keyed by indel k-mer context
    ik_prev_rows = ik_pad[:, :-1]  # ik_pad[j-1] for j=1..Ly
    ik_cur_rows = ik_pad[:, 1:]  # ik_pad[j]

    def total(name):
        return jnp.sum(rows_of(name) * row_valid, axis=1)

    out = {
        "fwd_score": fwd_score,
        "back_score": back_score,
        "match_counts": match_counts,
        "insert_counts": insert_counts,
        "m2m": keyed(rows_of("m2m"), ik_prev_rows, Ki),
        "m2i": keyed(rows_of("m2i"), ik_prev_rows, Ki),
        "m2d": keyed(rows_of("m2d"), ik_cur_rows, Ki),
        "m2e": keyed(rows_of("m2e"), ik_cur_rows, Ki),
        "i2i": total("i2i"),
        "i2m": total("i2m"),
        "d2d": total("d2d"),
        "d2m": total("d2m"),
    }
    if return_post:
        # [B, Ly, W] posterior probabilities, rows back in j=1..Ly order
        for name in ("post_mat", "post_ins", "post_del"):
            out[name] = jnp.moveaxis(rows[name][::-1], 0, 1)
    return out
