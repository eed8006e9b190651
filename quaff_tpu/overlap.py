"""Read-vs-read overlap detection pipeline.

Replaces the reference's QuaffOverlapAligner / QuaffOverlapTask /
QuaffOverlapScheduler (src/qoverlap.cpp:304-613): the pair-emission score
tables are built once per (params, strand) — fixing the reference's
per-task rebuild — pairs are enumerated in the reference's order
(ordered pairs over original reads vs everything later, including
reverse-complement copies), and each pair's banded Viterbi runs on device
with host traceback (including the adjacent-insert/delete squashing of
qoverlap.cpp:231-267).
"""

from __future__ import annotations

import math
import os
from typing import IO, List, Optional, Tuple

import numpy as np

from .aligner import DPConfig, VITERBI_CELL_SIZE
from .dp.engine import PairBatch, device_batch, pow2ceil
from .dp.overlap import OverlapScoreTables, overlap_device_tables, overlap_fill
from .dp.scores import ScoreTables
from .envelope import Envelope
from .formats.alignment import GAP_CHAR, Alignment, AlignmentPrinter
from .io.fastseq import FastSeq, KmerIndex, SeqIntervalCoords
from .model.params import QuaffNullParams, QuaffParams

NEG_INF = -math.inf


MATCH, INSERT, DELETE, START = 0, 1, 2, 3


def _y_strand_arrays(y: FastSeq, tables: OverlapScoreTables):
    """Per-position token/k-mer arrays for the second read.

    For reverse-strand pairs the reference scores the stored revcomp copy
    with arrays from the double-revcomp (= original) sequence, reversed
    back into the stored copy's coordinates (qoverlap.cpp:91-103); the
    quality array stays in stored coordinates.
    """
    if tables.y_complemented:
        y2 = y.revcomp()
        y_tok = y2.tokens()[::-1].copy()
        y_mk = y2.kmers(tables.match_kmer_len)[::-1].copy()
        y_ik = y2.kmers(tables.indel_kmer_len)[::-1].copy()
    else:
        y_tok = y.tokens()
        y_mk = y.kmers(tables.match_kmer_len)
        y_ik = y.kmers(tables.indel_kmer_len)
    y_q = y.qual_scores() if y.has_qual() else None
    return y_tok, y_mk, y_ik, y_q


def _insert_score_sum(tables: OverlapScoreTables, tok, qual) -> float:
    if qual is not None and len(qual) == len(tok):
        return float(np.sum(tables.insert_score[tok, qual]))
    return float(np.sum(tables.insert_score_noq[tok]))


class OverlapBatch:
    """Extends PairBatch with the x-side context arrays the overlap model
    needs (both sequences carry k-mer contexts and quality scores)."""

    def __init__(self, pairs: List[Tuple[FastSeq, FastSeq, Envelope]],
                 tables: OverlapScoreTables,
                 width: Optional[int] = None,
                 max_y_len: Optional[int] = None,
                 max_x_len: Optional[int] = None,
                 row_off: Optional[List[int]] = None,
                 n_rows: Optional[int] = None):
        st = ScoreTables.__new__(ScoreTables)  # only kmer lens used by build
        st.match_kmer_len = tables.match_kmer_len
        st.indel_kmer_len = tables.indel_kmer_len
        self.base = PairBatch.build(
            pairs, st, width=width, max_y_len=max_y_len, max_x_len=max_x_len
        )
        B = len(pairs)
        Lx = self.base.x_tok.shape[1]
        self.x_match_kmer = np.zeros((B, Lx), dtype=np.int32)
        self.x_indel_kmer_pad = np.zeros((B, Lx + 1), dtype=np.int32)
        self.x_qual = np.zeros((B, Lx), dtype=np.int32)
        self.x_has_qual = np.zeros(B, dtype=bool)
        self.x_insert_score = np.zeros(B)
        self.y_insert_score = np.zeros(B)
        self.y_arrays = []
        for b, (x, y, env) in enumerate(pairs):
            lx = len(x.seq)
            x_tok = x.tokens()
            self.x_match_kmer[b, :lx] = x.kmers(tables.match_kmer_len)
            self.x_indel_kmer_pad[b, 1 : lx + 1] = x.kmers(tables.indel_kmer_len)
            xq = x.qual_scores() if x.has_qual() else None
            if xq is not None:
                self.x_qual[b, :lx] = xq
                self.x_has_qual[b] = True
            self.x_insert_score[b] = _insert_score_sum(tables, x_tok, xq)
            y_tok, y_mk, y_ik, y_q = _y_strand_arrays(y, tables)
            ly = len(y.seq)
            self.base.y_tok[b, :ly] = y_tok
            self.base.y_match_kmer[b, :ly] = y_mk
            self.base.y_indel_kmer_pad[b, 1 : ly + 1] = y_ik
            self.y_insert_score[b] = _insert_score_sum(tables, y_tok, y_q)
            self.y_arrays.append((y_tok, y_mk, y_ik, y_q))
        self.row_off = None
        if row_off is not None:
            # trim each pair's y-side arrays to its live row window
            # [row_off+1, row_off+n_rows] (overlap_fill "j_off"); kmer
            # contexts were computed on the full sequence, so slicing
            # keeps them exact
            R = n_rows
            base = self.base
            yt = np.zeros((B, R), base.y_tok.dtype)
            ym = np.zeros((B, R), base.y_match_kmer.dtype)
            yq_a = np.zeros((B, R), base.y_qual.dtype)
            yik = np.zeros((B, R + 1), base.y_indel_kmer_pad.dtype)
            for b in range(B):
                o = int(row_off[b])
                n = max(0, min(R, int(base.y_len[b]) - o))
                yt[b, :n] = base.y_tok[b, o : o + n]
                ym[b, :n] = base.y_match_kmer[b, o : o + n]
                yq_a[b, :n] = base.y_qual[b, o : o + n]
                yik[b, : n + 1] = base.y_indel_kmer_pad[b, o : o + n + 1]
            base.y_tok, base.y_match_kmer = yt, ym
            base.y_qual, base.y_indel_kmer_pad = yq_a, yik
            base.max_y_len = R
            self.row_off = np.asarray(row_off, np.int32)

    def device(self) -> dict:
        import jax.numpy as jnp

        from .dp.engine import _narrow_int

        d = device_batch(self.base)
        d.update(
            {
                # pure gather indices downstream: narrow transfer dtypes
                "x_match_kmer": _narrow_int(
                    self.x_match_kmer, self.base.match_kmer_bound
                ),
                "x_indel_kmer_pad": _narrow_int(
                    self.x_indel_kmer_pad, self.base.indel_kmer_bound
                ),
                "x_qual": _narrow_int(self.x_qual, 94),
                "x_has_qual": jnp.asarray(self.x_has_qual),
                "x_insert_score": jnp.asarray(self.x_insert_score),
                "y_insert_score": jnp.asarray(self.y_insert_score),
            }
        )
        if self.row_off is not None:
            d["j_off"] = jnp.asarray(self.row_off)
        return d


def overlap_traceback(
    x: FastSeq,
    y: FastSeq,
    env: Envelope,
    tables: OverlapScoreTables,
    mat: np.ndarray,
    ins: np.ndarray,
    dele: np.ndarray,
    result: float,
    row_off: int = 0,
) -> Alignment:
    """QuaffOverlapViterbiMatrix::alignment (qoverlap.cpp:162-290).

    row_off: matrices from a row-trimmed fill store true row j at array
    row j - row_off (rows outside the window are outside the envelope,
    hence -inf)."""
    x_len, y_len = len(x.seq), len(y.seq)
    x_tok = x.tokens()
    x_mk = x.kmers(tables.match_kmer_len)
    x_ik = np.concatenate([[0], x.kmers(tables.indel_kmer_len)])
    x_q = x.qual_scores() if x.has_qual() else None
    y_tok, y_mk, y_ik_raw, y_q = _y_strand_arrays(y, tables)
    y_ik = np.concatenate([[0], y_ik_raw])

    d_lo, W = env.band_lo, env.band_width

    from .native import overlap_traceback_cols

    cols = overlap_traceback_cols(
        x_mk, x_ik, x_q, x_len, x_q is not None,
        y_mk, y_ik, y_q, y_len, y_q is not None,
        tables, row_off, d_lo, mat, ins, dele,
    )
    if cols is not None:
        from .dp.traceback import _cols_to_str

        col_x, col_y, x_start, x_end, y_start, y_end = cols
        row_x = FastSeq(
            name="read_x", comment=f"substr({x.name},{x_start}..{x_end})"
        )
        row_y = FastSeq(
            name="read_y", comment=f"substr({y.name},{y_start}..{y_end})"
        )
        row_x.seq = _cols_to_str(col_x, x.seq, GAP_CHAR)
        row_y.seq = _cols_to_str(col_y, y.seq, GAP_CHAR)
        if x_q is not None:
            row_x.qual = _cols_to_str(col_x, x.qual, "~")
        if y_q is not None:
            row_y.qual = _cols_to_str(col_y, y.qual, "~")
        row_x.source = SeqIntervalCoords(
            x.name, x_start, x_end, False
        ).compose(x.source)
        row_y.source = SeqIntervalCoords(
            y.name, y_start, y_end, False
        ).compose(y.source)
        return Alignment(gapped_seq=[row_x, row_y], score=result)

    def cell(arr, i, j):
        if j < 0 or j > y_len or i < 0 or i > x_len:
            return NEG_INF
        w = i - j - d_lo
        if w < 0 or w >= W:
            return NEG_INF
        r = j - row_off
        if r < 0 or r >= arr.shape[0]:
            return NEG_INF
        return float(arr[r, w])

    def match_emit(i, j):
        xi, yj = x_mk[i - 1], y_mk[j - 1]
        if x_q is not None and y_q is not None:
            return float(tables.pair_qq[xi, yj, x_q[i - 1], y_q[j - 1]])
        if x_q is not None:
            return float(tables.pair_xq[xi, yj, x_q[i - 1]])
        if y_q is not None:
            return float(tables.pair_yq[xi, yj, y_q[j - 1]])
        return float(tables.pair_nn[xi, yj])

    def m2m(i, j):
        return float(tables.m2m[x_ik[i], y_ik[j]])

    def m2i(i, j):
        return float(tables.m2i[x_ik[i], y_ik[j]])

    def m2d(i, j):
        return float(tables.m2d[x_ik[i], y_ik[j]])

    # end cell: best over the last row and last column (qoverlap.cpp:164-182)
    x_end, y_end = x_len, y_len
    best = cell(mat, x_len, y_len)
    for i_end in range(x_len, 0, -1):
        sc = cell(mat, i_end, y_len)
        if sc > best:
            best, x_end, y_end = sc, i_end, y_len
    for j_end in range(y_len, 0, -1):
        sc = cell(mat, x_len, j_end)
        if sc > best:
            best, x_end, y_end = sc, x_len, j_end

    i, j = x_end, y_end
    x_row: List[str] = []
    y_row: List[str] = []
    xq_row: List[str] = []
    yq_row: List[str] = []
    x_del: List[str] = []
    xq_del: List[str] = []
    y_ins: List[str] = []
    yq_ins: List[str] = []
    state = MATCH

    def prepend(dst, items):
        dst[:0] = items

    while state != START:
        if state == MATCH:
            emit = match_emit(i, j)
            i -= 1
            j -= 1
            new_x, new_y = [x.seq[i]], [y.seq[j]]
            new_xq = [x.qual[i]] if x_q is not None else []
            new_yq = [y.qual[j]] if y_q is not None else []
            cands = [
                (cell(mat, i, j) + m2m(i, j) + emit, MATCH),
                (cell(ins, i, j) + tables.i2m_eff + emit, INSERT),
                (cell(dele, i, j) + tables.d2m_eff + emit, DELETE),
            ]
            if j == 0 or i == 0:
                cands.append((emit, START))
            prepend(x_row, new_x)
            prepend(y_row, new_y)
            prepend(xq_row, new_xq)
            prepend(yq_row, new_yq)
        elif state == INSERT:
            j -= 1
            prepend(y_ins, [y.seq[j]])
            if y_q is not None:
                prepend(yq_ins, [y.qual[j]])
            cands = [
                (cell(mat, i, j) + m2i(i, j), MATCH),
                (cell(ins, i, j) + tables.i2i_eff, INSERT),
                (cell(dele, i, j) + tables.d2i_eff, DELETE),
            ]
        else:  # DELETE
            i -= 1
            prepend(x_del, [x.seq[i]])
            if x_q is not None:
                prepend(xq_del, [x.qual[i]])
            cands = [
                (cell(mat, i, j) + m2d(i, j), MATCH),
                (cell(ins, i, j) + tables.i2d_eff, INSERT),
                (cell(dele, i, j) + tables.d2d_eff, DELETE),
            ]
        src, state = NEG_INF, None
        for sc, st in cands:
            if sc > src:
                src, state = sc, st
        if state is None:
            raise RuntimeError("Overlap traceback error: no finite source")

        if state == MATCH:
            # squash adjacent insertions & deletions (qoverlap.cpp:231-267)
            ins_len, del_len = len(y_ins), len(x_del)
            shared = min(ins_len, del_len)
            extra_ins, extra_del = ins_len - shared, del_len - shared
            # gap-over-y columns (the unshared tail of the insert run)
            prepend(x_row, [GAP_CHAR] * extra_ins)
            prepend(y_row, y_ins[shared:])
            if x_q is not None:
                prepend(xq_row, ["~"] * extra_ins)
            if y_q is not None:
                prepend(yq_row, yq_ins[shared:])
            # x-over-gap columns
            prepend(x_row, x_del[shared:])
            prepend(y_row, [GAP_CHAR] * extra_del)
            if x_q is not None:
                prepend(xq_row, xq_del[shared:])
            if y_q is not None:
                prepend(yq_row, ["~"] * extra_del)
            # shared columns become aligned pairs
            prepend(x_row, x_del[:shared])
            prepend(y_row, y_ins[:shared])
            if x_q is not None:
                prepend(xq_row, xq_del[:shared])
            if y_q is not None:
                prepend(yq_row, yq_ins[:shared])
            x_del, xq_del, y_ins, yq_ins = [], [], [], []

    x_start, y_start = i + 1, j + 1
    row_x = FastSeq(
        name="read_x", comment=f"substr({x.name},{x_start}..{x_end})"
    )
    row_y = FastSeq(
        name="read_y", comment=f"substr({y.name},{y_start}..{y_end})"
    )
    row_x.seq = "".join(x_row)
    row_y.seq = "".join(y_row)
    row_x.qual = "".join(xq_row)
    row_y.qual = "".join(yq_row)
    row_x.source = SeqIntervalCoords(x.name, x_start, x_end, False).compose(x.source)
    row_y.source = SeqIntervalCoords(y.name, y_start, y_end, False).compose(y.source)
    return Alignment(gapped_seq=[row_x, row_y], score=result)


class QuaffOverlapAligner:
    def __init__(
        self,
        params: QuaffParams,
        null_model: QuaffNullParams,
        config: DPConfig,
    ):
        self.params = params
        self.null_model = null_model
        self.config = config
        # Table build + device upload cached ON the params object: the
        # pair-emission tables are the overlap mode's dominant fixed cost
        # (a 16*16*94*94 lse host build and ~36 MB of device tables),
        # and callers that construct a fresh aligner per
        # batch (with identical params) would pay them every time.  The
        # reference rebuilds them per TASK (qoverlap.cpp:77-79, a known
        # inefficiency SURVEY.md flags to hoist); we hoist per params.
        # Params objects are treated as immutable (the trainer's M-step
        # returns a new QuaffParams).
        cache = params.__dict__.get("_overlap_table_cache")
        if cache is None:
            base = ScoreTables.from_params(params)
            cache = params.__dict__["_overlap_table_cache"] = {
                "base": base,
                "fwd": OverlapScoreTables.from_params(params, False, base),
                "fwd_dev": None,
                "rev": None,
                "rev_dev": None,
                "cpu64": {},
            }
        self._tcache = cache
        self.tables_fwd = cache["fwd"]
        self.tables_rev: Optional[OverlapScoreTables] = cache["rev"]
        self._base = cache["base"]
        self._tdev_cpu64: dict = cache["cpu64"]
        # -mesh: device mesh for sharded pair scoring (set by the CLI;
        # the exact pass + traceback stay host-side either way)
        self.mesh = None

    def _tables(self, y_complemented: bool):
        """(host tables, engine device tables|None) for a strand.  The
        device tables build lazily via _tdev: building them eagerly
        would start the backend and upload ~36 MB at CONSTRUCTION — pure
        waste for the native small-workload path (time-to-first-result)."""
        if not y_complemented:
            return self.tables_fwd, self._tcache["fwd_dev"]
        if self.tables_rev is None:
            self.tables_rev = OverlapScoreTables.from_params(
                self.params, True, self._base
            )
            self._tcache["rev"] = self.tables_rev
        return self.tables_rev, self._tcache["rev_dev"]

    def _tdev(self, y_complemented: bool):
        """Engine device tables for a strand, built on first use."""
        key = "rev_dev" if y_complemented else "fwd_dev"
        if self._tcache[key] is None:
            self._tcache[key] = overlap_device_tables(
                self._tables(y_complemented)[0]
            )
        return self._tcache[key]

    def _null_ll(self, seq: FastSeq, comp: bool = False) -> float:
        """Null log-likelihood of a read (of its revcomp when comp),
        memoized on the FastSeq — in all-vs-all runs each read's value is
        needed once per pair it appears in (~N times), and the revcomp
        rebuild + token scan dominate the finish phase otherwise."""
        key = (id(self.null_model), comp)
        cache = seq.__dict__.setdefault("_null_ll_cache", {})
        if key not in cache:
            s = seq.revcomp() if comp else seq
            cache[key] = self.null_model.log_likelihood(s)
        return cache[key]

    def enumerate_pairs(self, seqs: List[FastSeq], n_originals: int):
        """The reference scheduler's pair order (qoverlap.cpp:475-547):
        (nx, ny) ascending with nx < ny, stopping once nx+1 >= nOriginals;
        ny >= nOriginals means the second read is a revcomp copy."""
        for nx in range(len(seqs)):
            if nx + 1 >= n_originals:
                break
            for ny in range(nx + 1, len(seqs)):
                yield nx, ny, ny >= n_originals

    def _exact_fill(self, batch: "OverlapBatch", tables, tdev) -> dict:
        """Run the exact banded fill for a (possibly padded) overlap batch
        and return host numpy arrays: score [B] and mat/ins/del
        [B, Ly, W].  The native C++ engine (native/overlapdp.cpp) is used
        when built — one threaded f64 fill per pair, no XLA dispatch; on
        accelerator backends the XLA fallback runs the f64 parity fill on
        the host CPU device (matrices never cross the device link)."""
        import jax

        from .native import overlap_fill_native

        res = overlap_fill_native(batch, tables)
        if res is not None:
            return res

        bdev = batch.device()
        if jax.default_backend() != "cpu":
            from .precision import x64_scope

            cpu = jax.devices("cpu")[0]
            with x64_scope(), jax.default_device(cpu):
                bdev = {k: jax.device_put(v, cpu) for k, v in bdev.items()}
                key = tables.y_complemented
                if key not in self._tdev_cpu64:
                    # f64 tables built inside the x64 scope, reused per strand
                    self._tdev_cpu64[key] = overlap_device_tables(tables)
                res = overlap_fill(
                    self._tdev_cpu64[key], bdev, return_matrices=True,
                    dtype=self.config.resolve_dtype(),
                )
                return {k: np.asarray(v) for k, v in res.items()}
        if tdev is None:  # lazily-built engine device tables (_tdev)
            tdev = self._tdev(tables.y_complemented)
        res = overlap_fill(
            tdev, bdev, return_matrices=True, dtype=self.config.resolve_dtype()
        )
        return {k: np.asarray(v) for k, v in res.items()}

    def _finish_pair(
        self,
        x: FastSeq,
        y: FastSeq,
        y_complemented: bool,
        env: Envelope,
        tables: OverlapScoreTables,
        res: dict,
        b: int,
        row_off: int = 0,
    ) -> Optional[Alignment]:
        score = float(res["score"][b])
        if not math.isfinite(score):
            return None
        from .logger import logger

        if logger.logging_tag("dpmatrix") and row_off == 0:
            from .dp.debug import write_dp_matrix

            write_dp_matrix(
                x, y, env, res["mat"][b], res["ins"][b], res["del"][b], score
            )
        a = overlap_traceback(
            x, y, env, tables, res["mat"][b], res["ins"][b], res["del"][b],
            score, row_off=row_off,
        )
        a.score -= self._null_ll(x) + self._null_ll(y, y_complemented)
        return a

    def overlap_pair(
        self, x: FastSeq, y: FastSeq, y_complemented: bool
    ) -> Optional[Alignment]:
        tables, tdev = self._tables(y_complemented)
        y_index = KmerIndex(y, self.config.kmer_len)
        env = self.config.make_envelope(x, y_index, VITERBI_CELL_SIZE)
        batch = OverlapBatch([(x, y, env)], tables)
        res = self._exact_fill(batch, tables, tdev)
        return self._finish_pair(x, y, y_complemented, env, tables, res, 0)

    def _use_fast_scores(self) -> bool:
        from . import device

        return device.device_scorers()

    def align_all(
        self,
        out: IO[str],
        seqs: List[FastSeq],
        n_originals: int,
        printer: AlignmentPrinter,
    ) -> None:
        printer.write_header(out, seqs, group_by_query=False)
        from .logger import logger

        pair_list = list(self.enumerate_pairs(seqs, n_originals))
        if (
            (self._use_fast_scores() or self.mesh is not None)
            and len(pair_list) > 1
            # full-envelope dpmatrix dumps need the sequential fills
            and not logger.logging_tag("dpmatrix")
        ):
            self._align_all_batched(out, seqs, pair_list, printer)
            return
        skip = None
        if (
            len(pair_list) > 1
            and printer.log_odds_threshold > NEG_INF
            and not logger.logging_tag("dpmatrix")
        ):
            skip = self._cpu_score_prepass(seqs, pair_list, printer)
        for k, (nx, ny, y_comp) in enumerate(pair_list):
            if skip is not None and skip[k]:
                continue
            a = self.overlap_pair(seqs[nx], seqs[ny], y_comp)
            if a is not None:
                printer.write_alignment(out, a)

    def _cpu_score_prepass(
        self, seqs, pair_list, printer, chunk_size: int = 32
    ) -> Optional[List[bool]]:
        """Score-only native prepass for the sequential (CPU) all-vs-all
        path: compute every pair's null-adjusted score with the
        matrix-free exact fill (bitwise equal to the full fill's score,
        thread-pooled) and mark pairs the printer would drop below its
        log-odds threshold — their full fill + traceback is skipped.
        Output is byte-identical to filling every pair (the reference
        also fills everything and thresholds at print time,
        qmodel.cpp:2570-2572; this just avoids the doomed matrices).
        Returns None when the native library is missing."""
        from .native import overlap_score_native

        def null_ll(i, comp=False):
            return self._null_ll(seqs[i], comp)

        y_indexes: dict = {}
        skip = [False] * len(pair_list)
        for y_comp in (False, True):
            idxs = [
                k for k, (_, _, yc) in enumerate(pair_list) if yc == y_comp
            ]
            if not idxs:
                continue
            tables, _ = self._tables(y_comp)
            for c0 in range(0, len(idxs), chunk_size):
                sub = idxs[c0 : c0 + chunk_size]
                pairs = []
                for k in sub:
                    nx, ny, _ = pair_list[k]
                    if ny not in y_indexes:
                        y_indexes[ny] = KmerIndex(
                            seqs[ny], self.config.kmer_len
                        )
                    env = self.config.make_envelope(
                        seqs[nx], y_indexes[ny], VITERBI_CELL_SIZE
                    )
                    pairs.append((seqs[nx], seqs[ny], env))
                batch = OverlapBatch(pairs, tables)
                sc = overlap_score_native(batch, tables)
                if sc is None:
                    return None
                for k, s in zip(sub, sc):
                    nx, ny, _ = pair_list[k]
                    adj = s - null_ll(nx) - null_ll(ny, y_comp)
                    skip[k] = adj < printer.log_odds_threshold
        return skip

    def _align_all_batched(self, out, seqs, pair_list, printer,
                           max_batch: int = 2048) -> None:
        """Batched all-vs-all overlap: score every pair's envelope strips
        on the device (overlap_fill, f32, score-only, one batch row per
        strip and its live row window), then run the exact f64 fill +
        traceback only for pairs whose (null-adjusted) score can clear
        the report threshold, filling only the strips that can supply
        the winner."""
        import jax
        import jax.numpy as jnp

        from .device import batch_items, record_dispatch, warm
        from .dp.overlap import overlap_bytes_per_row
        from .envelope import fit_envelope_lanes, pack_strips

        def round_up(v, m):
            return ((v + m - 1) // m) * m

        def null_ll(i, comp=False):
            return self._null_ll(seqs[i], comp)

        # each read's k-mer index is shared across all pairs it appears
        # in; built up-front so the prep pool can read the cache
        index_cache: dict = {}
        for ny in {ny for _, ny, _ in pair_list}:
            index_cache[ny] = KmerIndex(seqs[ny], self.config.kmer_len)

        # long-band guard: packed widths beyond the lane cap re-band with
        # the memory-fitted walk (envelope.fit_envelope_lanes) — same
        # policy as align/E-step (spurious seed clusters on long reads)
        lane_cap = int(os.environ.get("QUAFF_OVERLAP_LANE_CAP", "4096"))

        def _pair_job(p):
            nx, ny, y_comp = p
            env = self.config.make_envelope(
                seqs[nx], index_cache[ny], VITERBI_CELL_SIZE
            )
            wide = False
            if self.config.sparse:
                if sum(s.band_width for s in pack_strips(env)) > lane_cap:
                    env = fit_envelope_lanes(
                        seqs[nx], index_cache[ny], lane_cap,
                        band_size=self.config.band_size,
                        kmer_threshold=max(self.config.kmer_threshold, 0),
                    )
                    # still too wide (the top seed cluster itself exceeds
                    # the budget): no device scoring; the pair goes
                    # straight to the host exact pass, which handles any
                    # width
                    wide = sum(
                        s.band_width for s in pack_strips(env)
                    ) > lane_cap
            return (nx, ny, y_comp, env), len(pack_strips(env)), wide

        # thread the prep only when per-pair work is substantial (long
        # reads): the envelope build is mostly GIL-bound Python around
        # the native k-mer join, so pooling it is SLOWER at all-vs-all
        # sizes — measured 0.086 s serial vs 0.137 s pooled at 360
        # pairs, and 1.27 s serial vs 3.67 s pooled at 6048 pairs
        total_bases = sum(len(s.seq) for s in seqs)
        from concurrent.futures import ThreadPoolExecutor

        if (
            self.config.threads > 1
            and total_bases / max(len(seqs), 1) > 16384
        ):
            with ThreadPoolExecutor(self.config.threads) as ex:
                built = list(ex.map(_pair_job, pair_list))
        else:
            built = [_pair_job(p) for p in pair_list]
        jobs = [job for job, _, _ in built]
        wide_pairs = {(j[0], j[1]) for j, _, wide in built if wide}
        single_set: set = set()

        from .native import overlap_path_available

        use_shared_pool = overlap_path_available()

        # -nothreshold early-exact split: with the report threshold at
        # -inf the device score FILTER is dead — its only remaining value
        # is the per-strip scores that winnow the exact pass's
        # strip-picking fills.  A single-strip pair needs no winnowing,
        # so at -inf it skips device scoring and its f64 fill+traceback
        # starts IMMEDIATELY, under the device work of the multi-strip
        # minority (the exact pass, not the device, is the critical
        # path).
        if (
            self.mesh is None
            and printer.log_odds_threshold == NEG_INF
            and os.environ.get("QUAFF_OV_EARLY_EXACT", "1") != "0"
        ):
            for job, n_strips, wide in built:
                if not wide and n_strips <= 1:
                    single_set.add((job[0], job[1]))

        # Time-to-first-result small-workload gate: while this process
        # has not yet run the overlap scorer (its compilation costs
        # seconds, vs ~0.3 s of native fills for an 8-read all-vs-all),
        # an under-budget workload skips device scoring entirely: every
        # pair goes to the exact pass, which scores strips natively (f64)
        # and the printer applies the report threshold to the exact
        # scores.  Output identical; a warm scorer disables the gate so
        # repeated batches keep the device path.  (The platform is read
        # from jax.config, not jax.default_backend(), which would start
        # the backend this gate exists to avoid; CPU-pinned runs keep
        # the device-scoring path.)
        if (
            self.mesh is None
            and use_shared_pool
            and (jax.config.jax_platforms or "") != "cpu"
            and not warm("overlap")
        ):
            budget = int(
                os.environ.get("QUAFF_NATIVE_SMALL_CELLS", "40000000")
            )
            skip = wide_pairs | single_set
            # multi-strip pairs pay strip-score fills + the path fill:
            # ~2x their member cells
            cells = 2 * sum(
                s.band_width * rows
                for _, strips in self._strip_jobs(
                    seqs, [j for j in jobs if (j[0], j[1]) not in skip]
                )
                for s, _, rows in strips
            )
            if budget and cells <= budget:
                single_set |= {(j[0], j[1]) for j in jobs} - wide_pairs
        unscored = wide_pairs | single_set

        # device work: one batch row per envelope strip, bucketed by
        # (strand, padded width, padded live rows, padded x length) so
        # compiled shapes stay few
        scored_jobs = [j for j in jobs if (j[0], j[1]) not in unscored]
        buckets: dict = {}
        n_strips_of: dict = {}
        for job, strips in self._strip_jobs(seqs, scored_jobs):
            nx, ny, y_comp, env = job
            n_strips_of[(nx, ny)] = len(strips)
            for k, (s, off, rows) in enumerate(strips):
                key = (
                    y_comp,
                    round_up(max(s.band_width, 128), 128),
                    round_up(max(rows, 1), 512),
                    round_up(len(seqs[nx].seq), 512),
                )
                buckets.setdefault(key, []).append((job, k, s, off))

        # pipeline split: the exact pass overlaps the device work per
        # drained chunk, so one giant dispatch serialises host behind
        # device — aim for ~QUAFF_OV_PIPELINE_CHUNKS dispatches
        n_rows_total = sum(len(v) for v in buckets.values())
        target = int(os.environ.get("QUAFF_OV_PIPELINE_CHUNKS", "4"))
        chunks = []  # (key, padded batch, [(job, strip index, strip, row_off)])
        for key in sorted(buckets, key=lambda k: (-k[1] * k[2], k)):
            ents = buckets[key]
            _, wp, rp, lxp = key
            bcap = batch_items(
                overlap_bytes_per_row(wp, rp, lxp), max_batch
            )
            if target > 1 and len(ents) >= 16:
                bcap = min(bcap, pow2ceil(-(-n_rows_total // target)))
            for i in range(0, len(ents), bcap):
                c = ents[i : i + bcap]
                chunks.append((key, pow2ceil(len(c)), c))

        exact_futs = []
        exact_ex = None
        shared_xc: dict = {}
        shared_yc: dict = {}

        def _submit_path_jobs(cands_, seg_scores=None):
            # slice size: small enough for incremental flushing / load
            # balance, large enough to amortise the batched native call
            chunk = int(os.environ.get("QUAFF_OV_EXACT_CHUNK", "12"))
            jobs_ = self._strip_jobs(seqs, cands_, seg_scores=seg_scores)
            # heaviest first: the pool drains FIFO, so an expensive pair
            # queued last becomes the wall-clock pole of the whole pass
            jobs_.sort(
                key=lambda it: -sum(r * s.band_width for s, _, r in it[1])
            )
            # render=False: workers return raw traceback payloads and the
            # incremental writer below renders them on the main thread —
            # keeping the workers' duty cycle almost purely native
            # (GIL-free) so the fills genuinely run in parallel
            w = self._path_worker(
                seqs, shared_xc, shared_yc, jobs_, render=False
            )
            for i in range(0, len(jobs_), chunk):
                exact_futs.append(exact_ex.submit(w.slice, jobs_[i : i + chunk]))

        # Exact-pass pool, created BEFORE the device dispatches: wide
        # pairs and (at -inf threshold) single-strip pairs need no device
        # scores, so their f64 fills start now and run under the device
        # work.  With the native path the pool is one thread per core
        # and tasks are ~12-pair slices.
        if self.mesh is None and jobs:
            # prebuild every strand's tables on the main thread BEFORE the
            # pool exists: the lazy rev-strand build is not thread-safe
            for yc in {j[2] for j in jobs}:
                self._tables(yc)
            exact_ex = ThreadPoolExecutor(
                (os.cpu_count() or 1) if use_shared_pool else 1
            )
            early = [j for j in jobs if (j[0], j[1]) in unscored]
            if use_shared_pool:
                if early:
                    _submit_path_jobs(early)
            else:
                # chunked so the incremental writer below can drain early
                # futures while later ones still fill
                for i in range(0, len(early), 96):
                    exact_futs.append(
                        exact_ex.submit(self._exact_pass, seqs, early[i : i + 96])
                    )

        def strip_batch(key, bq, chunk):
            y_comp, wp, rp, lxp = key
            ents = chunk + [chunk[-1]] * (bq - len(chunk))
            tables, _ = self._tables(y_comp)
            ob = OverlapBatch(
                [(seqs[j[0]], seqs[j[1]], s) for j, _, s, _ in ents],
                tables, width=wp, max_x_len=lxp,
                row_off=[off for _, _, _, off in ents], n_rows=rp,
            )
            return ob.device()

        # slack covers the f32 device scores' difference from the f64
        # exact pass
        slack = 1.0
        strip_scores: dict = {}  # (nx, ny) -> [score per strip]
        scored: dict = {}

        def record(chunk, s):
            """Strip scores landed; returns the pairs they completed
            that can clear the report threshold."""
            done = []
            for (job, k, _, _), sc in zip(chunk, s):
                key = (job[0], job[1])
                v = strip_scores.setdefault(key, [None] * n_strips_of[key])
                v[k] = float(sc)
                if all(x is not None for x in v):
                    scored[key] = max(v)
                    adj = scored[key] - null_ll(job[0]) - null_ll(
                        job[1], job[2]
                    )
                    if math.isfinite(scored[key]) and (
                        adj >= printer.log_odds_threshold - slack
                    ):
                        done.append(job)
            return done

        def submit_cands(cc):
            if not cc or exact_ex is None:
                return
            snap = {(j[0], j[1]): strip_scores[(j[0], j[1])] for j in cc}
            if use_shared_pool:
                _submit_path_jobs(cc, seg_scores=snap)
            else:
                exact_futs.append(
                    exact_ex.submit(self._exact_pass, seqs, cc, seg_scores=snap)
                )

        if self.mesh is not None:
            self._mesh_overlap_scores(chunks, strip_batch, record)
        else:
            # dispatch every chunk before fetching any (JAX dispatch is
            # async), then drain in order: each chunk's candidates start
            # their exact fills while later chunks still run
            pending = []
            for key, bq, chunk in chunks:
                record_dispatch("overlap")
                dev = overlap_fill(
                    self._tdev(key[0]), strip_batch(key, bq, chunk),
                    return_matrices=False, dtype=jnp.float32,
                )["score"]
                pending.append((chunk, dev))
            for chunk, dev in pending:
                submit_cands(record(chunk, np.asarray(dev, np.float64)))

        # On a multi-host mesh run only host 0 writes output; the other
        # hosts stop after the (collective) scoring phase — the exact
        # pass below is pure host work
        if self.mesh is not None:
            from .parallel.distributed import is_primary

            if not is_primary():
                return

        cands = []
        for job in jobs:
            key = (job[0], job[1])
            if key in unscored:
                # unscored (band beyond the lane cap, or a single-strip
                # pair at -inf threshold): always take the exact pass
                cands.append(job)
                continue
            sc = scored[key]
            if not math.isfinite(sc):
                continue
            adj = sc - null_ll(job[0]) - null_ll(job[1], job[2])
            if adj < printer.log_odds_threshold - slack:
                continue
            cands.append(job)
        if exact_ex is not None:
            # incremental write: f.result() below WAITS in submission
            # order, which is all the ordered flush relies on.  After each
            # future lands, flush every leading candidate whose alignment
            # is now known so the (serial, GIL-bound) formatting overlaps
            # the remaining native fills.  (Do not refactor to
            # as_completed: ordered flushing would break.)
            results = {}
            cursor = 0
            for f in exact_futs:
                results.update(f.result())
                while cursor < len(cands):
                    key = (cands[cursor][0], cands[cursor][1])
                    if key not in results:
                        break
                    a = results[key]
                    if a is not None:
                        if isinstance(a, tuple):  # deferred render
                            a = self._render_path(seqs, a)
                        printer.write_alignment(out, a)
                    cursor += 1
            exact_ex.shutdown()
        else:
            results = self._exact_pass(seqs, cands, seg_scores=strip_scores)
            cursor = 0
        for nx, ny, y_comp, env in cands[cursor:]:
            a = results[(nx, ny)]
            if a is not None:
                if isinstance(a, tuple):  # deferred render
                    a = self._render_path(seqs, a)
                printer.write_alignment(out, a)

    def _mesh_overlap_scores(self, chunks, strip_batch, record) -> None:
        """-mesh strip scoring: overlap_fill runs D chunks at a time
        inside shard_map over the device mesh (the mesh analogue of the
        overlap scheduler's task farming, qoverlap.cpp:554-566).  Chunks
        are grouped by identical padded shape so every device runs one
        program; short groups repeat their last chunk; pair-emission
        tables replicate.  Scores are allgathered to every host of a
        multi-host cluster."""
        from jax.sharding import PartitionSpec as P

        from .device import record_dispatch
        from .parallel.distributed import global_array
        from .parallel.estep import gather_scores, sharded_overlap_scores

        D = self.mesh.devices.size
        groups: dict = {}
        for key, bq, chunk in chunks:
            groups.setdefault((key, bq), []).append(chunk)
        for (key, bq), glist in sorted(groups.items()):
            tdev_g = {
                k: global_array(self.mesh, P(), np.asarray(v))
                for k, v in self._tdev(key[0]).items()
            }
            for g0 in range(0, len(glist), D):
                gset = glist[g0 : g0 + D]
                padded = gset + [gset[-1]] * (D - len(gset))
                host = [
                    {k: np.asarray(v) for k, v in strip_batch(key, bq, c).items()}
                    for c in padded
                ]
                stacked = {
                    k: global_array(
                        self.mesh, P("dp"), np.stack([d[k] for d in host])
                    )
                    for k in host[0]
                }
                record_dispatch("overlap")
                s = gather_scores(
                    sharded_overlap_scores(self.mesh, tdev_g, stacked)
                )
                for chunk, srow in zip(gset, np.asarray(s, np.float64)):
                    record(chunk, srow)

    def _path_worker(self, seqs, x_cache, y_cache, jobs, render=True):
        """Per-item exact-path work callable over SHARED lazy caches.

        Strand score tables are prebuilt here (their lazy build is not
        thread-safe); the per-(seq, strand) array caches fill lazily and
        tolerate concurrent duplicate computes (values are deterministic
        — a racing write just overwrites with an equal value), so one
        (x_cache, y_cache) pair can back work items spread across many
        pool tasks.

        render=False returns raw traceback payloads instead of Alignment
        objects (finish with _render_path).  Pool workers use this: the
        string building is GIL-bound, and with 4 workers cycling
        [native fill, GIL-free] -> [render, GIL] the GIL demand sits
        near 100% duty and the fills stall waiting to reacquire it
        (measured 2.1x per-call wall inflation, ~2.1/4 core utilisation
        at N=64).  Rendering on the main-thread writer loop instead
        overlaps it with the fills without contending for workers'
        GIL slots."""
        from .dp.traceback import _cols_to_str
        from .native import (
            _overlap_tabs,
            overlap_strip_score_native,
            overlap_viterbi_path_cols,
            overlap_viterbi_path_cols_batch,
        )

        for (nx, ny, yc, env), _ in jobs:
            _overlap_tabs(self._tables(yc)[0])
            self._null_ll(seqs[nx])
            self._null_ll(seqs[ny], yc)

        def get_x(nx, yc):
            v = x_cache.get((nx, yc))
            if v is None:
                tables = self._tables(yc)[0]
                x = seqs[nx]
                x_tok = x.tokens()
                x_q = x.qual_scores() if x.has_qual() else None
                v = (
                    x.kmers(tables.match_kmer_len),
                    np.concatenate([[0], x.kmers(tables.indel_kmer_len)]),
                    x_q,
                    _insert_score_sum(tables, x_tok, x_q),
                )
                x_cache[(nx, yc)] = v
            return v

        def get_y(ny, yc):
            v = y_cache.get((ny, yc))
            if v is None:
                tables = self._tables(yc)[0]
                y_tok, y_mk, y_ik_raw, y_q = _y_strand_arrays(
                    seqs[ny], tables
                )
                v = (
                    y_mk,
                    np.concatenate([[0], y_ik_raw]),
                    y_q,
                    _insert_score_sum(tables, y_tok, y_q),
                )
                y_cache[(ny, yc)] = v
            return v

        def pick(item):
            """Winner strip + the per-call argument tuple for one item."""
            (nx, ny, yc, env), strips = item
            tables = self._tables(yc)[0]
            x_mk, x_ik_pad, x_q, x_ins = get_x(nx, yc)
            y_mk, y_ik_pad, y_q, y_ins = get_y(ny, yc)
            x_len = len(seqs[nx].seq)
            y_len = len(seqs[ny].seq)
            best = 0
            if len(strips) > 1:
                best_sc = None
                for k, (s, off, rows) in enumerate(strips):
                    end = overlap_strip_score_native(
                        x_mk, x_ik_pad, x_q, x_len, x_q is not None,
                        y_mk, y_ik_pad, y_q, y_len, y_q is not None,
                        off, rows, s.band_lo, s.band_width,
                        s.member_mask(), tables,
                    )
                    # same summed-score comparison (and first-wins tie
                    # order) as the matrix path's res["score"] argmax
                    sc = (end + x_ins) + y_ins
                    if best_sc is None or sc > best_sc:
                        best_sc, best = sc, k
            s, off, rows = strips[best]
            return (nx, ny, yc, x_ins, y_ins, (
                x_mk, x_ik_pad, x_q, x_len, x_q is not None,
                y_mk, y_ik_pad, y_q, y_len, y_q is not None,
                off, rows, s.band_lo, s.band_width, s.member_mask(),
                tables,
            ))

        def emit(nx, ny, yc, x_ins, y_ins, cols, end):
            score = (end + x_ins) + y_ins
            if cols is None or not math.isfinite(score):
                return (nx, ny), None
            if not render:
                return (nx, ny), (nx, ny, yc, cols, score)
            return (nx, ny), self._render_path(
                seqs, (nx, ny, yc, cols, score)
            )

        def work(item):
            nx, ny, yc, x_ins, y_ins, args = pick(item)
            cols, end = overlap_viterbi_path_cols(*args)
            return emit(nx, ny, yc, x_ins, y_ins, cols, end)

        def work_slice(items):
            """All items of a slice through ONE batched native call —
            the worker stays in GIL-free C for the whole slice's fills
            instead of reacquiring the GIL 30-argument-marshalling
            per task (the measured 4-thread scaling limiter)."""
            picks = [pick(item) for item in items]
            res = overlap_viterbi_path_cols_batch([p[5] for p in picks])
            return dict(
                emit(nx, ny, yc, xi, yi, cols, end)
                for (nx, ny, yc, xi, yi, _), (cols, end)
                in zip(picks, res)
            )

        work.slice = work_slice
        return work

    def _render_path(self, seqs, payload):
        """Alignment object from a _path_worker(render=False) payload —
        the GIL-bound half of the exact pass, run on the main-thread
        writer loop so it overlaps the pool's native fills."""
        from .dp.traceback import _cols_to_str

        nx, ny, yc, cols, score = payload
        x, y = seqs[nx], seqs[ny]
        col_x, col_y, x_start, x_end, y_start, y_end = cols
        row_x = FastSeq(
            name="read_x", comment=f"substr({x.name},{x_start}..{x_end})"
        )
        row_y = FastSeq(
            name="read_y", comment=f"substr({y.name},{y_start}..{y_end})"
        )
        row_x.seq = _cols_to_str(col_x, x.seq, GAP_CHAR)
        row_y.seq = _cols_to_str(col_y, y.seq, GAP_CHAR)
        if x.has_qual():
            row_x.qual = _cols_to_str(col_x, x.qual, "~")
        if y.has_qual():
            row_y.qual = _cols_to_str(col_y, y.qual, "~")
        row_x.source = SeqIntervalCoords(
            x.name, x_start, x_end, False
        ).compose(x.source)
        row_y.source = SeqIntervalCoords(
            y.name, y_start, y_end, False
        ).compose(y.source)
        a = Alignment(gapped_seq=[row_x, row_y], score=score)
        a.score -= self._null_ll(x) + self._null_ll(y, yc)
        return a

    def _strip_jobs(self, seqs, cands, max_segs=None, seg_scores=None,
                    seg_slack: float = 0.25) -> list:
        """Strip selection for the exact pass: each candidate becomes
        (job, [(strip, row_off, rows), ...]) with only the strips that
        can supply the winning traceback.  When the device's per-strip
        scores are available (seg_scores, pack_strips order — see
        _align_all_batched), only strips within
        seg_slack nats of the pair's best strip are kept: the
        non-winning strips (typically the always-included diagonal-0
        strip, diagenv.cpp:53) never supply the traceback, so their f64
        fills are pure waste."""
        from .envelope import pack_strips

        if max_segs is None:
            # must match the device scoring's strips for seg_scores to
            # line up
            max_segs = 3
        jobs: list = []
        for job in cands:
            nx, ny, y_comp, env = job
            x_len, y_len = len(seqs[nx].seq), len(seqs[ny].seq)
            segs = pack_strips(env, max_segs)
            keep = range(len(segs))
            if seg_scores is not None and (nx, ny) in seg_scores:
                sm = seg_scores[(nx, ny)]
                best = max(
                    (sm[k] for k in range(len(segs))), default=-math.inf
                )
                if math.isfinite(best):
                    keep = [
                        k for k in range(len(segs))
                        if sm[k] >= best - seg_slack
                    ]
            strips = []
            for k in keep:
                s = segs[k]
                # live row window of the strip: member diagonal d has
                # cells at rows j with 1 <= d + j <= x_len
                d1, d2 = int(s.diagonals[0]), int(s.diagonals[-1])
                j0 = max(1, 1 - d2)
                rows = max(min(y_len, x_len - d1) - j0 + 1, 1)
                strips.append((s, j0 - 1, rows))
            jobs.append((job, strips))
        return jobs

    def _exact_pass(self, seqs, cands, max_segs: int = None,
                    max_elems: int = 20_000_000, seg_scores: dict = None,
                    seg_slack: float = 0.25) -> dict:
        """Batched f64 parity fills for the candidate pairs, one batch row
        per envelope STRIP rather than per bounding band: the always-
        included diagonal 0 (diagenv.cpp:53) routinely leaves the seed
        cluster thousands of diagonals away, so the bounding band is
        mostly gap lanes the reference's ragged storage never touches.
        Strips are independent DP subproblems (envelope.strips), so the
        pair score is the max of its strip scores and the traceback runs
        inside the winning strip.  Candidates are bucketed by padded
        shape and chunked whole (all strips of a pair in one fill) so a
        chunk's matrices can be dropped as soon as its pairs finish.

        When the device's per-strip scores are available (seg_scores,
        pack_strips order — see _align_all_batched),
        only strips within seg_slack nats of the pair's best strip are
        filled: the non-winning strips (typically the always-included
        diagonal-0 strip, diagenv.cpp:53) never supply the traceback, so
        their f64 matrices are pure waste."""
        def round_up(v, m):
            return ((v + m - 1) // m) * m

        results: dict = {}
        jobs = self._strip_jobs(seqs, cands, max_segs, seg_scores,
                                seg_slack)

        from .native import overlap_path_available

        if overlap_path_available():
            # matrix-free path: per-strip score-only fills pick each
            # pair's winner, then one checkpointed fill+traceback call
            # walks it — no DP matrices ever materialise (the stored
            # fill writes 3x the cells it reads back and is
            # store-bandwidth-bound, like the align winner pass)
            return self._exact_pass_path(seqs, jobs)

        buckets: dict = {}
        for (job, strips) in jobs:
            nx, ny, y_comp, env = job
            x_len, y_len = len(seqs[nx].seq), len(seqs[ny].seq)
            wp = round_up(max(max(s.band_width for s, _, _ in strips), 64), 64)
            key = (
                y_comp,
                wp,
                round_up(max(r for _, _, r in strips), 512),
                round_up(x_len, 512),
            )
            buckets.setdefault(key, []).append((job, strips))
        pending: list = []  # (chunk, y_comp, wp, lyp, lxp)
        for (y_comp, wp, lyp, lxp), js in sorted(buckets.items()):
            # cap the f64 matrix footprint (3 matrices x B x lyp x wp),
            # keeping each pair's strips within a single chunk
            max_b = max(1, int(max_elems // (lyp * wp)))
            chunk: list = []
            n_in_chunk = 0
            for job, strips in js:
                if chunk and n_in_chunk + len(strips) > max_b:
                    pending.append((chunk, y_comp, wp, lyp, lxp))
                    chunk = []
                    n_in_chunk = 0
                chunk.append((job, strips))
                n_in_chunk += len(strips)
            if chunk:
                pending.append((chunk, y_comp, wp, lyp, lxp))

        def fill_chunk(item):
            chunk, y_comp, wp, lyp, lxp = item
            tables, tdev = self._tables(y_comp)
            entries = [
                (seqs[j[0]], seqs[j[1]], s)
                for j, ss in chunk
                for s, _, _ in ss
            ]
            offs = [o for _, ss in chunk for _, o, _ in ss]
            ob = OverlapBatch(
                entries, tables, width=wp, max_x_len=lxp,
                row_off=offs, n_rows=lyp,
            )
            return self._exact_fill(ob, tables, tdev)

        def finish_chunk(item, res):
            chunk, y_comp, wp, lyp, lxp = item
            tables, _ = self._tables(y_comp)
            b = 0
            for (nx, ny, yc, env), ss in chunk:
                best_b, best_sc = b, float(res["score"][b])
                for k in range(1, len(ss)):
                    sc = float(res["score"][b + k])
                    if sc > best_sc:
                        best_b, best_sc = b + k, sc
                s_env, s_off, _ = ss[best_b - b]
                results[(nx, ny)] = self._finish_pair(
                    seqs[nx], seqs[ny], yc, s_env, tables, res,
                    best_b, row_off=s_off,
                )
                b += len(ss)

        # -threads N parallelises the f64 chunk fills (the native fill
        # releases the GIL), windowed to bound in-flight matrices;
        # finish stays sequential in chunk order
        if self.config.threads > 1 and len(pending) > 1:
            from concurrent.futures import ThreadPoolExecutor

            for yc in {it[1] for it in pending}:
                self._tables(yc)  # lazy strand-table build isn't thread-safe

            T = self.config.threads
            with ThreadPoolExecutor(T) as ex:
                futs: dict = {}
                for i, item in enumerate(pending):
                    futs[i] = ex.submit(fill_chunk, item)
                    if i >= T:
                        j = i - T
                        finish_chunk(pending[j], futs.pop(j).result())
                for j in sorted(futs):
                    finish_chunk(pending[j], futs.pop(j).result())
        else:
            for item in pending:
                finish_chunk(item, fill_chunk(item))
        return results

    def _exact_pass_path(self, seqs, jobs) -> dict:
        """Matrix-free exact pass: per pair, score-only f64 fills pick
        the winning strip (only when more than one strip survived the
        device scores' seg_slack cut), then ONE checkpointed fill+traceback
        native call (qdp_overlap_viterbi_path) walks it.  Every cell the
        walk reads is bitwise equal to the stored fill's, the winner
        comparison uses the same summed f64 scores in the same order,
        and the walk replicates qdp_overlap_traceback — output
        byte-identical to the matrix path (pinned by
        test_native.test_overlap_viterbi_path_*).  Cost ~2 score-fills
        per pair instead of 3x-stored fills of every kept strip; pairs
        parallelise across host cores (the native calls release the
        GIL), replacing the batched fill's internal per-pair pool."""
        import os
        from concurrent.futures import ThreadPoolExecutor

        work = self._path_worker(seqs, {}, {}, jobs)

        results: dict = {}
        if len(jobs) > 1:
            with ThreadPoolExecutor(
                min(len(jobs), os.cpu_count() or 1)
            ) as ex:
                for key, a in ex.map(work, jobs):
                    results[key] = a
        else:
            for item in jobs:
                key, a = work(item)
                results[key] = a
        return results
