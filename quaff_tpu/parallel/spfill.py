"""Sequence-parallel banded fill: the band sharded across devices.

The extension sketched in SURVEY §5.7: when a pair's band is too wide for
one core (ultra-long reads / wide envelopes), the dense diagonal band is
partitioned across an "sp" mesh axis.  Per DP row:

  * match state is embarrassingly parallel (same-lane dependency);
  * the insert state's lane-(w+1) dependency needs one halo column from
    the right neighbour (ppermute);
  * the in-row delete recursion — a prefix scan in the (max,+) or
    (logaddexp,+) semiring — becomes a textbook distributed scan: local
    prefix per shard, all_gather of the S per-shard aggregates, exclusive
    combine of the aggregates, then a local fix-up;
  * the end reduction is a mesh-wide max / log-sum-exp.

Per-row collectives make this latency-bound on real hardware — it is the
correct tool only when the band genuinely exceeds a core's memory — but
the implementation is exact: scores match the single-device engine.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..dp.engine import NEG_INF


def _combine_for(mode):
    return jnp.maximum if mode == "viterbi" else jnp.logaddexp


def sp_fill_scores(
    mesh: Mesh,
    tables_dev: dict,
    batch_dev: dict,
    mode: str = "viterbi",
    local: bool = True,
    dtype=jnp.float32,
    axis: str = "sp",
):
    """Band-sharded banded DP; returns end scores [B].

    batch_dev is a standard device batch dict; its `member` width must be
    divisible by the sp axis size.  All y-side arrays are replicated; the
    band state and x context are computed per shard from lane offsets.
    """
    S = mesh.shape[axis]

    def body(tables, batch):
        combine = _combine_for(mode)
        x_tok = batch["x_tok"]
        x_len = batch["x_len"]
        y_tok = batch["y_tok"]
        y_match_kmer = batch["y_match_kmer"]
        ik_pad = batch["y_indel_kmer_pad"]
        y_qual = batch["y_qual"]
        y_has_qual = batch["y_has_qual"]
        y_len = batch["y_len"]
        d_lo = batch["d_lo"]
        member = batch["member"]  # sharded [B, W/S]

        B, Wl = member.shape
        Ly = y_tok.shape[1]
        neg_inf = jnp.array(NEG_INF, dtype=dtype)
        shard = jax.lax.axis_index(axis)
        lane0 = shard * Wl  # global lane offset of this shard
        lane = lane0 + jnp.arange(Wl, dtype=jnp.int32)[None, :]

        match_score = tables["match_score"].astype(dtype)
        match_score_noq = tables["match_score_noq"].astype(dtype)
        insert_score = tables["insert_score"].astype(dtype)
        insert_score_noq = tables["insert_score_noq"].astype(dtype)
        m2m_t = tables["m2m"].astype(dtype)
        m2i_t = tables["m2i"].astype(dtype)
        m2d_t = tables["m2d"].astype(dtype)
        m2e_t = tables["m2e"].astype(dtype)
        d2d = tables["d2d"].astype(dtype)
        d2m = tables["d2m"].astype(dtype)
        i2i = tables["i2i"].astype(dtype)
        i2m = tables["i2m"].astype(dtype)

        right = [(s, (s + 1) % S) for s in range(S)]  # halo from right
        left = [(s, (s - 1) % S) for s in range(S)]

        def halo_from_right(col):
            # receive the right neighbour's value; my column goes left
            out = jax.lax.ppermute(col, axis, left)
            # the last shard has no right neighbour
            return jnp.where(shard == S - 1, neg_inf, out)

        def shift_hi(v):
            # lane w reads w+1; the shard's last lane reads the right
            # neighbour's first lane
            rolled = jnp.concatenate(
                [v[:, 1:], jnp.full((B, 1), neg_inf, dtype)], axis=1
            )
            halo = halo_from_right(v[:, 0])  # [B]
            return rolled.at[:, Wl - 1].set(halo)

        def shift_lo_with_halo(v, halo_left):
            rolled = jnp.concatenate(
                [jnp.full((B, 1), neg_inf, dtype), v[:, :-1]], axis=1
            )
            return rolled.at[:, 0].set(halo_left)

        def row_step(carry, j):
            mat_p, ins_p, del_p, end = carry

            ik_prev = ik_pad[:, j - 1]
            ik_cur = ik_pad[:, j]
            m2m_j = m2m_t[ik_prev][:, None]
            m2i_j = m2i_t[ik_prev][:, None]
            m2d_j = m2d_t[ik_cur][:, None]
            m2e_j = m2e_t[ik_cur][:, None]

            ykm = y_match_kmer[:, j - 1]
            yq = y_qual[:, j - 1]
            yt = y_tok[:, j - 1]
            mrow = jnp.where(
                y_has_qual[:, None],
                match_score[:, ykm, yq].T,
                match_score_noq[:, ykm].T,
            )
            ins_emit = jnp.where(
                y_has_qual, insert_score[yt, yq], insert_score_noq[yt]
            )[:, None]

            idx = d_lo[:, None] + (j - 1) + lane
            valid = (
                member
                & (idx >= 0)
                & (idx < x_len[:, None])
                & (j <= y_len)[:, None]
            )
            xtok_lane = jnp.take_along_axis(
                x_tok, jnp.clip(idx, 0, x_tok.shape[1] - 1), axis=1
            )
            emit = jnp.take_along_axis(mrow, xtok_lane, axis=1)

            mat_c = combine(combine(mat_p + m2m_j, del_p + d2m), ins_p + i2m)
            start_ok = (j == 1) & (local | (idx == 0))
            mat_c = combine(
                mat_c, jnp.where(start_ok, jnp.zeros((), dtype), neg_inf)
            )
            mat_c = jnp.where(valid, mat_c + emit, neg_inf)

            ins_c = ins_emit + combine(
                shift_hi(ins_p) + i2i, shift_hi(mat_p) + m2i_j
            )
            ins_c = jnp.where(valid, ins_c, neg_inf)

            # ---- distributed delete scan ----
            mat_left = halo_from_left = jax.lax.ppermute(
                mat_c[:, Wl - 1], axis, right
            )
            halo_left = jnp.where(shard == 0, neg_inf, mat_left)
            b_vec = jnp.where(
                valid, shift_lo_with_halo(mat_c, halo_left) + m2d_j, neg_inf
            )
            c_vec = jnp.where(valid, d2d, neg_inf)
            # local prefix (inclusive) in the (combine, +) semiring
            def op(l, r):
                c1, b1 = l
                c2, b2 = r
                return c1 + c2, combine(b1 + c2, b2)

            c_pref, b_pref = jax.lax.associative_scan(
                op, (c_vec, b_vec), axis=-1
            )
            # shard aggregates -> exclusive cross-shard prefix
            aggC = c_pref[:, -1]  # [B]
            aggB = b_pref[:, -1]
            allC = jax.lax.all_gather(aggC, axis)  # [S, B]
            allB = jax.lax.all_gather(aggB, axis)

            def fold(s, acc):
                accC, accB = acc
                take = s < shard
                newC = jnp.where(take, accC + allC[s], accC)
                newB = jnp.where(take, combine(accB + allC[s], allB[s]), accB)
                return newC, newB

            accC = jnp.zeros((B,), dtype)
            accB = jnp.full((B,), neg_inf, dtype)
            accC, accB = jax.lax.fori_loop(0, S, fold, (accC, accB))
            # fix up: del = combine(exclusive_prefix_B + local_C, local_B)
            del_c = combine(accB[:, None] + c_pref, b_pref)
            del_c = jnp.where(valid, del_c, neg_inf)

            end_ok = valid & (local | (idx == x_len[:, None] - 1))
            row_end = jnp.where(end_ok, mat_c + m2e_j, neg_inf)
            if mode == "viterbi":
                contrib = jnp.max(row_end, axis=1)
            else:
                contrib = jax.nn.logsumexp(row_end, axis=1)
            end = combine(end, jnp.where(j == y_len, contrib, neg_inf))
            return (mat_c, ins_c, del_c, end), None

        init = (
            jnp.full((B, Wl), neg_inf, dtype),
            jnp.full((B, Wl), neg_inf, dtype),
            jnp.full((B, Wl), neg_inf, dtype),
            jnp.full((B,), neg_inf, dtype),
        )
        (_, _, _, end), _ = jax.lax.scan(
            row_step, init, jnp.arange(1, Ly + 1, dtype=jnp.int32)
        )
        # mesh-wide end reduction
        if mode == "viterbi":
            end = jax.lax.pmax(end, axis)
        else:
            m = jax.lax.pmax(end, axis)
            m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
            s = jax.lax.psum(jnp.exp(end - m_safe), axis)
            end = jnp.where(s > 0, m_safe + jnp.log(s), neg_inf)
        return end

    specs = {name: P() for name in batch_dev}
    specs["member"] = P(None, axis)  # band lanes sharded
    f = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), specs),
        out_specs=P(),
        check_vma=False,
    )
    return f(tables_dev, batch_dev)
