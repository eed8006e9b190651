"""Banded Viterbi scorer for the align path: a Pallas kernel for NVIDIA
GPUs, compiled through the Triton route.

It computes what `dp_fill(mode="viterbi", return_matrices=False)` computes
on the same batch (engine.py holds the recursion and its derivation), in
float32, keeping each pair's three DP states on chip for the whole row
loop instead of writing them to device memory after every row.

Layout.  The grid runs over the pairs, all in parallel, one pair per
program (two or four pairs per program ran 1.2x and 1.8x slower at their
best warp counts on an H100 at the c8f30 align shape); each program
loops over the read's rows with the pair's [1, W] match/insert/delete
states as loop carries.  What a row needs from the
read side (four match emissions, the insert emission and the three
context-dependent transitions) is gathered once per batch by XLA into a
[8, rows, pairs] table, so the loop loads eight scalars per pair and
row.  The reference token under each lane is read straight from `x_tok`
at `d_lo + row + lane`.

Lane shifts.  Triton exposes no cross-lane shuffle, so every shift goes
through a per-pair scratch row in device memory: the program stores the
vector, meets a block-wide barrier, and loads it back at an offset.
The insert state needs one shift of the previous row (both its sources
sit on lane w+1), and the in-row delete chain

    del[w] = max(del[w-1] + d2d, b[w])            over a run of valid lanes

is a max-plus prefix scan done in log2(reach) doubling steps.  Because
d2d is one constant, the sum of the chain's step scores over the
s lanes ending at w is simply s*d2d when those lanes are all valid, so
only `b` is shifted at each step; validity comes from the length of the
run of valid lanes ending at each lane.  Scratch slots alternate so
that every slot is rewritten only after a barrier that follows its last
read.

In interpret mode (the CPU tests) the barrier is skipped: the
interpreter runs each program sequentially.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import device
from .engine import NEG_INF, two_sum

# widest block the kernel takes; wider batches score on the host (one
# device) or through the sequence-parallel fill (a mesh).  Bounded by
# registers: ~10 live [pairs, W] f32 vectors per program at up to 16
# warps.
MAX_LANES = 4096

# scratch slots per pair: match x2, insert x2, delete-scan x2
_SLOT_MAT, _SLOT_INS, _SLOT_SCAN = 0, 2, 4
_N_SLOTS = 6


def _pow2(n: int, minimum: int = 1) -> int:
    p = minimum
    while p < n:
        p *= 2
    return p


def kernel_width(width: int) -> int:
    """Lane count of the kernel block for a batch of `width` lanes."""
    return _pow2(width, 16)


def scan_reach(seg_width) -> int:
    """Static delete-scan reach for a lane-packed batch: its widest
    strip, rounded up to a power of two so compiled variants stay few."""
    return _pow2(max(int(np.max(seg_width)), 1))


def bytes_per_pair(width: int, rows: int, x_len: int) -> int:
    """Device bytes one pair takes in a batch: its row table (8 f32 per
    row), reference tokens, per-lane tables, scratch rows and output."""
    W = kernel_width(width)
    return 32 * rows + 4 * x_len + (12 + 4 * 3 * _N_SLOTS + 4) * W


def row_params(tables_dev: dict, batch: dict) -> jnp.ndarray:
    """[8, Ly, B] f32: per pair and read row j (index j-1), the match
    emission for each reference symbol (channels 0-3), the insert
    emission (4), m2m and m2i of the previous row's indel context (5, 6)
    and m2d of this row's (7)."""
    f32 = jnp.float32
    ykm = batch["y_match_kmer"].astype(jnp.int32)
    yq = batch["y_qual"].astype(jnp.int32)
    yt = batch["y_tok"].astype(jnp.int32)
    hq = batch["y_has_qual"][:, None]
    ik = batch["y_indel_kmer_pad"].astype(jnp.int32)
    ms = tables_dev["match_score"].astype(f32)
    msn = tables_dev["match_score_noq"].astype(f32)
    chans = [
        jnp.where(hq, ms[a][ykm, yq], msn[a][ykm]) for a in range(4)
    ]
    chans.append(
        jnp.where(
            hq,
            tables_dev["insert_score"].astype(f32)[yt, yq],
            tables_dev["insert_score_noq"].astype(f32)[yt],
        )
    )
    chans.append(tables_dev["m2m"].astype(f32)[ik[:, :-1]])
    chans.append(tables_dev["m2i"].astype(f32)[ik[:, :-1]])
    chans.append(tables_dev["m2d"].astype(f32)[ik[:, 1:]])
    return jnp.stack(chans).transpose(0, 2, 1)


def _kernel(rowp_ref, x_ref, member_ref, lastinv_ref, doff_ref, meta_ref,
            trans_ref, out_ref, off_ref, off_lo_ref, scr_ref, *, W,
            n_rows, local, reach, interpret):
    p = pl.program_id(0)
    pairs = pl.ds(p, 1)
    f32 = jnp.float32
    neg = jnp.full((1, W), NEG_INF, f32)
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, W), 1)
    brow = jnp.full((1, W), p, jnp.int32)

    def barrier():
        if not interpret:
            plgpu.debug_barrier()

    x_len = meta_ref[0, pairs][:, None]
    y_len = meta_ref[1, pairs][:, None]
    doff = doff_ref[pairs, :]  # diagonal of each lane
    member = member_ref[pairs, :] != 0
    lastinv_m = lastinv_ref[pairs, :]
    d2d = trans_ref[0]
    d2m = trans_ref[1]
    i2i = trans_ref[2]
    i2m = trans_ref[3]
    lx = x_ref.shape[1]

    def shifted(slot, off, ok):
        return plgpu.load(
            scr_ref.at[pairs, slot, pl.ds(W + off, W)], mask=ok, other=NEG_INF
        )

    def row(r, carry):
        mat_p, ins_p, del_p, end_acc, off_hi, off_lo, end_hi, end_lo = carry
        j = r + 1
        par = jnp.bitwise_and(r, 1)
        e = [rowp_ref[c, r, pairs][:, None] for c in range(8)]

        idx = doff + r  # x index (i - 1) of each lane
        in_x = (idx >= 0) & (idx < x_len)
        valid = member & in_x & (j <= y_len)
        tok = x_ref[brow, jnp.clip(idx, 0, lx - 1)]
        emit = jnp.where(tok == 0, e[0], neg)
        for a in (1, 2, 3):
            emit = jnp.where(tok == a, e[a], emit)

        # insert sources sit on lane w+1 of the previous row
        prev_ok = (lane < W - 1) & (r > 0)
        hi_mat = shifted(_SLOT_MAT + 1 - par, 1, prev_ok)
        hi_ins = shifted(_SLOT_INS + 1 - par, 1, prev_ok)

        mat_c = jnp.maximum(
            jnp.maximum(mat_p + e[5], del_p + d2m), ins_p + i2m
        )
        start_ok = (j == 1) & (True if local else (idx == 0))
        mat_c = jnp.maximum(mat_c, jnp.where(start_ok, 0.0, neg))
        mat_c = jnp.where(valid, mat_c + emit, neg)
        ins_c = e[4] + jnp.maximum(hi_ins + i2i, hi_mat + e[6])
        ins_c = jnp.where(valid, ins_c, neg)

        # rebase: the row's best state becomes 0 and the pair's offset
        # grows by it, summed in two floats (TwoSum), so f32 rounding acts
        # on per-row magnitudes rather than on the whole path's score
        top = jnp.max(jnp.maximum(mat_c, ins_c), axis=1, keepdims=True)
        top = jnp.where(top > NEG_INF, top, 0.0)
        mat_c = mat_c - top
        ins_c = ins_c - top
        off_hi, err = two_sum(off_hi, top)
        off_lo = off_lo + err

        scr_ref[pairs, _SLOT_MAT + par, pl.ds(W, W)] = mat_c
        scr_ref[pairs, _SLOT_INS + par, pl.ds(W, W)] = ins_c
        barrier()
        lo_mat = shifted(_SLOT_MAT + par, -1, lane >= 1)

        # delete chain: max-plus prefix scan over runs of valid lanes.
        # Within a strip x indices rise with the lane, so the lanes with
        # idx < 0 end at lane - idx - 1.
        last_invalid = jnp.where(
            in_x, jnp.maximum(lastinv_m, lane - idx - 1), lane
        )
        run = jnp.where(valid, lane - last_invalid, 0)
        b = jnp.where(valid, lo_mat + e[7], neg)
        s, k = 1, 0
        while s < reach:
            scr_ref[pairs, _SLOT_SCAN + k % 2, pl.ds(W, W)] = b
            barrier()
            b_s = shifted(_SLOT_SCAN + k % 2, -s, lane >= s)
            step = jnp.where(run >= s, s * d2d, neg)
            b = jnp.maximum(b_s + step, b)
            s, k = 2 * s, k + 1
        del_c = jnp.where(valid, b, neg)

        end_ok = valid & (j == y_len)
        if not local:
            end_ok = end_ok & (idx == x_len - 1)
        end_acc = jnp.where(end_ok, mat_c, end_acc)
        last = j == y_len
        end_hi = jnp.where(last, off_hi, end_hi)
        end_lo = jnp.where(last, off_lo, end_lo)
        return mat_c, ins_c, del_c, end_acc, off_hi, off_lo, end_hi, end_lo

    zero = jnp.zeros((1, 1), f32)
    carry = (neg, neg, neg, neg, zero, zero, zero, zero)
    _, _, _, end_acc, _, _, end_hi, end_lo = jax.lax.fori_loop(
        0, n_rows, row, carry
    )
    out_ref[pairs, :] = end_acc
    off_ref[pairs] = end_hi.reshape(1)
    off_lo_ref[pairs] = end_lo.reshape(1)


def _warps(W: int) -> int:
    """Warps per program: one per 256 lanes (on an H100 at W=512, two
    warps ran 13.3 ms per 256 c8f30 pairs, one 18.9 ms, four 14.1 ms)."""
    return max(1, min(16, W // 256))


# diagonal of lanes outside every strip of a lane-packed batch: far
# beyond any x index, so such lanes are never valid
D_SENTINEL = 1 << 24


def lane_diagonals(batch: dict, W: int) -> jnp.ndarray:
    """[B, W] int32 diagonal (i - j) of every lane: d_lo + lane for a
    bounding-band batch, each strip's own diagonals for a lane-packed
    one (`PairBatch.build_packed`)."""
    lane = jnp.arange(W, dtype=jnp.int32)[None, :]
    if "seg_d_lo" not in batch:
        return batch["d_lo"].astype(jnp.int32)[:, None] + lane
    B = batch["seg_d_lo"].shape[0]
    doff = jnp.full((B, W), D_SENTINEL, jnp.int32)
    for k in range(batch["seg_d_lo"].shape[1]):
        start = batch["seg_start"][:, k, None].astype(jnp.int32)
        width = batch["seg_width"][:, k, None].astype(jnp.int32)
        d_lo = batch["seg_d_lo"][:, k, None].astype(jnp.int32)
        in_seg = (lane >= start) & (lane < start + width)
        doff = jnp.where(in_seg, d_lo + lane - start, doff)
    return doff


def viterbi_scores(tables_dev: dict, batch: dict, local: bool = True,
                   reach=None, return_segments: bool = False):
    """Viterbi end score [B] (f32, -inf where no path) of every pair of a
    batch — the score `dp_fill` gives a bounding-band batch.  Lane-packed
    batches are scored strip by strip in one block; with
    return_segments=True the per-strip scores [B, S] (pack_strips order)
    come back too, and the pair score is their max.

    reach: widest strip (or run of member lanes) in the batch, where the
    delete scan may stop; None scans the whole block.  Off a GPU backend
    the kernel runs in the Pallas interpreter (the CPU tests); where the
    device scorers run it is always compiled."""
    return _viterbi_scores(
        tables_dev, batch, local=local, reach=reach,
        return_segments=return_segments,
        interpret=not device.device_scorers(),
    )


@partial(
    jax.jit,
    static_argnames=("local", "reach", "return_segments", "interpret"),
)
def _viterbi_scores(tables_dev, batch, local, reach, return_segments,
                    interpret):
    member = batch["member"]
    B, W0 = member.shape
    W = kernel_width(W0)
    if W > MAX_LANES:
        raise ValueError(f"band width {W0} exceeds the kernel's {MAX_LANES}")
    Ly = int(batch["y_tok"].shape[1])
    reach = W if reach is None else min(_pow2(int(reach)), W)

    rowp = row_params(tables_dev, batch)
    x_tok = batch["x_tok"].astype(jnp.int32)
    member_i = jnp.zeros((B, W), jnp.int32).at[:, :W0].set(
        member.astype(jnp.int32)
    )
    lane = jnp.arange(W, dtype=jnp.int32)[None, :]
    lastinv = jax.lax.cummax(jnp.where(member_i == 0, lane, -1), axis=1)
    doff = lane_diagonals(batch, W)
    meta = jnp.stack([batch["x_len"], batch["y_len"]]).astype(jnp.int32)
    trans = jnp.stack(
        [tables_dev[k].astype(jnp.float32) for k in ("d2d", "d2m", "i2i", "i2m")]
    )
    kernel = partial(
        _kernel, W=W, n_rows=Ly, local=local, reach=reach,
        interpret=interpret,
    )
    end_acc, end_hi, end_lo, _ = pl.pallas_call(
        kernel,
        grid=(B,),
        out_shape=(
            jax.ShapeDtypeStruct((B, W), jnp.float32),
            jax.ShapeDtypeStruct((B,), jnp.float32),
            jax.ShapeDtypeStruct((B,), jnp.float32),
            jax.ShapeDtypeStruct((B, _N_SLOTS, 3 * W), jnp.float32),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=_warps(W), num_stages=1
        ),
        interpret=interpret,
        name="quaff_align_viterbi",
    )(rowp, x_tok, member_i, lastinv, doff, meta, trans)
    ik = batch["y_indel_kmer_pad"].astype(jnp.int32)
    y_len = batch["y_len"].astype(jnp.int32)
    m2e_end = tables_dev["m2e"].astype(jnp.float32)[
        jnp.take_along_axis(ik, y_len[:, None], 1)[:, 0]
    ]
    # the path's score: its end row's offset, in two floats, plus the end
    # cell relative to it
    rel = end_acc + (m2e_end + end_lo)[:, None]
    end = rel + end_hi[:, None]
    scores = jnp.max(end, axis=1)
    if not return_segments:
        return scores
    start = batch["seg_start"].astype(jnp.int32)[:, :, None]
    stop = start + batch["seg_width"].astype(jnp.int32)[:, :, None]
    in_seg = (lane[None] >= start) & (lane[None] < stop)
    segs = jnp.max(jnp.where(in_seg, end[:, None, :], NEG_INF), axis=2)
    return scores, segs
