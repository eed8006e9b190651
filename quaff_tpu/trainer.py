"""Baum-Welch EM training and E-step counting.

Replaces the reference's QuaffTrainer / QuaffCountingScheduler / counting
tasks (src/qmodel.cpp:1909-2478): the per-(read, ref) Forward-Backward
fills run as batched device computations (dp_forward_backward); the
reference's per-read bookkeeping — null-model baseline, running
log-likelihood, the Δ=20 backward-pass skip, posterior count weighting,
and best-first ref ordering with pruning (qmodel.cpp:2238-2271) — is kept
exactly so EM trajectories match.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from .aligner import DPConfig, FWDBACK_CELL_SIZE
from .dp.counts import dp_forward_backward
from . import device
from .device import batch_items, record_dispatch, warm
from .dp.engine import PairBatch, device_batch, device_tables, pow2ceil
from .dp.scores import ScoreTables
from .io.fastseq import FastSeq, KmerIndex
from .model.params import QuaffCounts, QuaffNullParams, QuaffParamCounts, QuaffParams

# EM convergence parameters (reference qmodel.h:19-20)
MAX_EM_ITERATIONS = 100
MIN_EM_LOGLIKE_INC = 0.01

# pairs per device E-step call: bounds the work of one dispatch (the
# memory budget, device.batch_items, usually binds first at long reads)
_ESTEP_MAX_BATCH = 1024

# drop refs whose log-likelihood trails the total by more than this
# (MAX_TRAINING_LOG_DELTA, qmodel.cpp:23)
MAX_TRAINING_LOG_DELTA = 20.0


def _log_sum_exp(a: float, b: float) -> float:
    if a == -math.inf:
        return b
    if b == -math.inf:
        return a
    m = max(a, b)
    return m + math.log1p(math.exp(-abs(a - b)))


def _extract_pair_counts(res: dict, b: int, mk: int, ik: int) -> QuaffCounts:
    return QuaffCounts(
        match_kmer_len=mk,
        indel_kmer_len=ik,
        insert=np.asarray(res["insert_counts"][b], dtype=np.float64),
        match=np.asarray(res["match_counts"][b], dtype=np.float64),
        m2m=np.asarray(res["m2m"][b], dtype=np.float64),
        m2i=np.asarray(res["m2i"][b], dtype=np.float64),
        m2d=np.asarray(res["m2d"][b], dtype=np.float64),
        m2e=np.asarray(res["m2e"][b], dtype=np.float64),
        i2i=float(res["i2i"][b]),
        i2m=float(res["i2m"][b]),
        d2d=float(res["d2d"][b]),
        d2m=float(res["d2m"][b]),
    )


class QuaffCounter:
    """E-step count computation for reads against references."""

    def __init__(
        self,
        params: QuaffParams,
        null_model: QuaffNullParams,
        config: DPConfig,
        use_null_model: bool = True,
        prefer_device: bool = True,
    ):
        self.params = params
        self.null_model = null_model
        self.config = config
        self.use_null_model = use_null_model
        self.prefer_device = prefer_device
        self.tables = ScoreTables.from_params(params)
        self._tdev_cache = None
        self._tdev_cpu64 = None

    @property
    def _tdev(self):
        """Engine device tables, built on first use (an eager build at
        construction initialised the backend + uploaded tables the
        small-workload CPU route never touches)."""
        if self._tdev_cache is None:
            self._tdev_cache = device_tables(self.tables)
        return self._tdev_cache

    def _use_device(self) -> bool:
        return self.prefer_device and device.device_scorers()

    def _small_cpu_estep_gate(self, refs, reads, sort_order) -> bool:
        """Time-to-first-result: run a small E-step on the CPU-device
        f64 engine (the parity path — compiles locally in seconds and
        caches persistently) instead of paying this process's backend
        start-up and its first device E-step compilation.  Active only
        while the device E-step is cold and the estimated workload is
        under the shared QUAFF_NATIVE_SMALL_CELLS budget; warm processes
        and production batches keep the device path."""
        import os

        import jax

        budget = int(os.environ.get("QUAFF_NATIVE_SMALL_CELLS", "40000000"))
        if (
            not budget
            or not self.prefer_device
            or warm("estep")
            or (jax.config.jax_platforms or "").split(",")[0] == "cpu"
        ):
            return False
        # rough fwd+bwd cell estimate: default-band width x read length
        # per candidate pair, x3 for the two passes + count reduction
        est = sum(
            3 * 420 * len(reads[ny].seq) * max(len(sort_order[ny]), 1)
            for ny in range(len(reads))
        )
        return est <= budget

    def count_read(
        self, refs: List[FastSeq], y: FastSeq, sort_order: List[int],
        cpu_engine: bool = False,
    ) -> Tuple[QuaffParamCounts, float, List[int]]:
        """One read's posterior-weighted counts against all refs
        (QuaffCountingTask::run, qmodel.cpp:2238-2271).

        Returns (counts, log-likelihood, updated ref sort order).
        """
        y_null_ll = (
            self.null_model.log_likelihood(y) if self.use_null_model else -math.inf
        )
        if not sort_order:
            mk, ik = self.params.match_kmer_len, self.params.indel_kmer_len
            return QuaffParamCounts.zero(mk, ik), y_null_ll, sort_order

        y_index = KmerIndex(y, self.config.kmer_len)
        envs = {
            nx: self.config.make_envelope(refs[nx], y_index, FWDBACK_CELL_SIZE)
            for nx in sort_order
        }
        pairs = [(refs[nx], y, envs[nx]) for nx in sort_order]
        batch = PairBatch.build(pairs, self.tables)
        from .logger import logger

        want_post = logger.logging_tag("postmatrix")
        if cpu_engine:
            # small-workload TTFR route (_small_cpu_estep_gate): the f64
            # parity engine pinned to the host CPU device — compiles
            # locally (persistent cache), never touches the accelerator
            import jax
            import jax.numpy as jnp

            from .precision import x64_scope

            cpu = jax.devices("cpu")[0]
            with x64_scope(), jax.default_device(cpu):
                if self._tdev_cpu64 is None:
                    self._tdev_cpu64 = device_tables(self.tables)
                bdev = {
                    k: jax.device_put(v, cpu)
                    for k, v in device_batch(batch).items()
                }
                res = dp_forward_backward(
                    self._tdev_cpu64,
                    bdev,
                    local=self.config.local,
                    dtype=jnp.float64,
                    num_match_kmers=self.params.num_match_kmers,
                    num_indel_kmers=self.params.num_indel_kmers,
                    return_post=want_post,
                )
                res = {k: np.asarray(v) for k, v in res.items()}
        else:
            if self._use_device():
                record_dispatch("estep")
            res = dp_forward_backward(
                self._tdev,
                device_batch(batch),
                local=self.config.local,
                dtype=self.config.resolve_dtype(),
                num_match_kmers=self.params.num_match_kmers,
                num_indel_kmers=self.params.num_indel_kmers,
                return_post=want_post,
            )
        fwd = np.asarray(res["fwd_score"], dtype=np.float64)
        back = np.asarray(res["back_score"], dtype=np.float64)
        # fwd/back self-check (MAX_FRACTIONAL_FWDBACK_ERROR,
        # qmodel.cpp:20,1496-1497: warn when |fwd-back| exceeds 1e-4
        # of min(|fwd|,|back|))
        for pos in range(len(sort_order)):
            f, bk = fwd[pos], back[pos]
            if (
                math.isfinite(f)
                and math.isfinite(bk)
                and abs(f - bk) > 1e-4 * min(abs(f), abs(bk))
            ):
                logger.log(
                    0,
                    f"\n\nWarning: forward score ({f:g}) does not match "
                    f"backward score ({bk:g})\n\n\n",
                )

        def dump_post(pos, nx):
            from .dp.debug import write_post_matrix

            write_post_matrix(
                refs[nx], y, envs[nx],
                np.asarray(res["post_mat"][pos]),
                np.asarray(res["post_ins"][pos]),
                np.asarray(res["post_del"][pos]),
            )

        return self._weigh_read(
            len(refs), sort_order, fwd, res, y_null_ll,
            on_backward=dump_post if want_post else None,
        )

    def _weigh_read(self, n_refs, sort_order, fwd, res, y_null_ll,
                    on_backward=None):
        """Posterior-weighted counts of one read from its pairs' forward
        scores and per-pair counts (res rows in sort order): the
        reference's running log-likelihood with the Δ=20 backward skip,
        then the best-first re-sort that prunes unproductive refs
        (qmodel.cpp:2238-2271)."""
        mk, ik = self.params.match_kmer_len, self.params.indel_kmer_len
        y_counts = QuaffParamCounts.zero(mk, ik)
        xy_loglike = np.full(n_refs, -math.inf)
        took_backward = np.zeros(n_refs, dtype=bool)
        y_loglike = y_null_ll
        for pos, nx in enumerate(sort_order):
            xy_loglike[nx] = fwd[pos]
            if xy_loglike[nx] >= y_loglike - MAX_TRAINING_LOG_DELTA:
                took_backward[nx] = True
            y_loglike = _log_sum_exp(y_loglike, xy_loglike[nx])

        for pos, nx in enumerate(sort_order):
            if not took_backward[nx] or not math.isfinite(xy_loglike[nx]):
                continue
            if on_backward is not None:
                on_backward(pos, nx)
            post = math.exp(xy_loglike[nx] - y_loglike)
            qc = _extract_pair_counts(res, pos, mk, ik)
            y_counts.add_weighted(QuaffParamCounts.from_counts(qc), post)

        new_order = sorted(range(n_refs), key=lambda nx: -xy_loglike[nx])
        new_order = [
            nx
            for nx in new_order
            if xy_loglike[nx] >= y_loglike - MAX_TRAINING_LOG_DELTA
        ]
        return y_counts, y_loglike, new_order

    def get_counts(
        self,
        refs: List[FastSeq],
        reads: List[FastSeq],
        sort_order: Optional[List[List[int]]] = None,
    ) -> Tuple[QuaffParamCounts, float, List[List[int]]]:
        """Counts summed over all reads (QuaffTrainer::getCounts).

        Where the device scorers run, pairs from MANY reads are batched
        into single device E-step calls (the analogue of the reference's
        read-level thread pool, qmodel.cpp:2005-2031) — one call per
        shape bucket instead of one per read."""
        mk, ik = self.params.match_kmer_len, self.params.indel_kmer_len
        if sort_order is None:
            sort_order = [list(range(len(refs))) for _ in reads]
        from .logger import ProgressLogger, logger

        plog = ProgressLogger(level=2)
        plog.init_progress("Expected counts (E-step)")
        cpu_engine = (
            not logger.logging_tag("postmatrix")
            and self._small_cpu_estep_gate(refs, reads, sort_order)
        )
        if (
            not cpu_engine
            and len(reads) > 1
            and self._use_device()
            and not logger.logging_tag("postmatrix")
        ):
            out = self._get_counts_batched(refs, reads, sort_order, plog)
            plog.done()
            return out
        total = QuaffParamCounts.zero(mk, ik)
        loglike = 0.0
        new_orders: List[List[int]] = []
        for ny, y in enumerate(reads):
            plog.log_progress(ny / max(len(reads), 1), f"read {ny + 1}/{len(reads)}")
            y_counts, y_ll, order = self.count_read(
                refs, y, sort_order[ny], cpu_engine=cpu_engine
            )
            total.add_weighted(y_counts, 1.0)
            loglike += y_ll
            new_orders.append(order)
        plog.done()
        return total, loglike, new_orders

    def _device_estep(self, batch: PairBatch) -> dict:
        """One jitted forward-backward call for a bucket of pairs on the
        device; per-pair scores and counts come back to the host."""
        record_dispatch("estep")
        res = dp_forward_backward(
            self._tdev,
            device_batch(batch),
            local=self.config.local,
            dtype=self.config.resolve_dtype(),
            num_match_kmers=self.params.num_match_kmers,
            num_indel_kmers=self.params.num_indel_kmers,
        )
        return {k: np.asarray(v) for k, v in res.items()}

    def _get_counts_batched(self, refs, reads, sort_order, plog):
        """Cross-read E-step: all (read, ref) pairs bucketed by (band
        width, read-length pad) and run through dp_forward_backward on
        the device, one call per chunk; each read's posterior weighting,
        Δ=20 backward skip and ref re-ordering then run on the host in
        f64 exactly as count_read does (_weigh_read)."""
        from .dp.counts import BYTES_PER_CELL

        mk, ik = self.params.match_kmer_len, self.params.indel_kmer_len
        null_lls = [
            self.null_model.log_likelihood(y) if self.use_null_model else -math.inf
            for y in reads
        ]

        def round_up(v, m):
            return ((v + m - 1) // m) * m

        # long-band guard: a pair whose band exceeds the lane cap is
        # re-banded with the memory-fitted walk (envelope.
        # fit_envelope_lanes — the reference's diagenv.cpp:60-106 with
        # the device cost model); the cap bounds the work of one pair
        lane_cap = int(os.environ.get("QUAFF_ESTEP_LANE_CAP", "4096"))
        jobs = []  # (ny, nx, env)
        oversize = []  # reads whose band stays over the cap after refit
        for ny, y in enumerate(reads):
            if not sort_order[ny]:
                continue
            y_index = KmerIndex(y, self.config.kmer_len)
            read_jobs = []
            for nx in sort_order[ny]:
                env = self.config.make_envelope(
                    refs[nx], y_index, FWDBACK_CELL_SIZE
                )
                if self.config.sparse and env.band_width > lane_cap:
                    from .envelope import fit_envelope_lanes

                    env = fit_envelope_lanes(
                        refs[nx], y_index, lane_cap,
                        band_size=self.config.band_size,
                        kmer_threshold=max(self.config.kmer_threshold, 0),
                    )
                    if env.band_width > lane_cap:
                        # even the top seed level is wider than the cap:
                        # this read takes the per-read path below
                        read_jobs = None
                        break
                read_jobs.append((ny, nx, env))
            if read_jobs is None:
                oversize.append(ny)
            else:
                jobs.extend(read_jobs)
        # Chunking: greedy over reads, longest first, within each width
        # group; the batch size is a power of two under the device
        # memory budget for the chunk's (rows x width) forward rows.
        groups: dict = {}
        for job in jobs:
            wp = round_up(max(job[2].band_width, 128), 128)
            groups.setdefault(wp, []).append(job)
        pair_counts = {}  # (ny, nx) -> (res, row)
        n_done = 0
        for wp, js in sorted(groups.items()):
            js.sort(key=lambda j: -len(reads[j[0]].seq))
            i = 0
            while i < len(js):
                lp = round_up(len(reads[js[i][0]].seq), 512)
                b_cap = batch_items(BYTES_PER_CELL * wp * (lp + 1), _ESTEP_MAX_BATCH)
                chunk = js[i : i + b_cap]
                i += len(chunk)
                B = len(chunk)
                pairs = [
                    (refs[nx], reads[ny], env) for ny, nx, env in chunk
                ]
                # pad B to a power-of-two quantum so compiled shapes stay
                # few; the pad pairs repeat the last entry and are dropped
                pairs.extend([pairs[-1]] * (pow2ceil(B) - B))
                res = self._device_estep(
                    PairBatch.build(pairs, self.tables, width=wp, max_y_len=lp)
                )
                for b, (ny, nx, env) in enumerate(chunk):
                    pair_counts[(ny, nx)] = (res, b)
                n_done += B
                plog.log_progress(
                    n_done / max(len(jobs), 1),
                    f"{n_done}/{len(jobs)} pair fills",
                )

        total = QuaffParamCounts.zero(mk, ik)
        loglike = 0.0
        new_orders: List[List[int]] = []
        for ny in range(len(reads)):
            if ny in oversize:
                y_counts, y_ll, order = self.count_read(
                    refs, reads[ny], sort_order[ny]
                )
            else:
                # the read's per-pair results gathered into one row table,
                # in its sort order
                rows = [pair_counts[(ny, nx)] for nx in sort_order[ny]]
                res = {
                    k: np.stack([r[k][b] for r, b in rows])
                    for k in (rows[0][0] if rows else ())
                }
                fwd = np.asarray(res.get("fwd_score", ()), np.float64)
                y_counts, y_ll, order = self._weigh_read(
                    len(refs), sort_order[ny], fwd, res, null_lls[ny]
                )
            total.add_weighted(y_counts, 1.0)
            loglike += y_ll
            new_orders.append(order)
        return total, loglike, new_orders


@dataclass
class QuaffTrainer:
    """EM driver (QuaffTrainer::fit, qmodel.cpp:2169-2231)."""

    max_iterations: int = MAX_EM_ITERATIONS
    min_fractional_loglike_increment: float = MIN_EM_LOGLIKE_INC
    max_read_bases: int = 0
    allow_null_model: bool = True
    save_params_filename: str = ""
    raw_counts_filename: str = ""
    counts_with_prior_filename: str = ""
    checkpoint_dir: str = ""  # preemption-safe EM state checkpointing

    def effective_reads(self, reads: List[FastSeq]) -> List[FastSeq]:
        """-maxreadmb training-set truncation (qmodel.cpp:2169-2183);
        exposed so external counts providers see the same read list."""
        if self.max_read_bases <= 0:
            return reads
        limited = []
        bases = 0
        for y in reads:
            limited.append(y)
            bases += len(y.seq)
            if bases >= self.max_read_bases:
                break
        return limited

    def fit(
        self,
        refs: List[FastSeq],
        reads: List[FastSeq],
        seed: QuaffParams,
        null_model: QuaffNullParams,
        pseudocounts: QuaffParamCounts,
        config: DPConfig,
        log=lambda *a: None,
        counts_provider=None,
    ) -> QuaffParams:
        """EM fit.  counts_provider, when given, replaces the local
        E-step: a callable (params, sort_order) -> (counts, loglike,
        sort_order) — used to farm counting to remote/qsub workers each
        iteration (QuaffTrainer::fit remote dispatch,
        qmodel.cpp:2050-2120)."""
        reads = self.effective_reads(reads)
        assert pseudocounts.match_kmer_len == seed.match_kmer_len
        assert pseudocounts.indel_kmer_len == seed.indel_kmer_len

        qp = seed
        prev_ll_with_prior = -math.inf
        sort_order = [list(range(len(refs))) for _ in reads]
        start_iter = 0
        if self.checkpoint_dir:
            from .checkpoint import TrainState, load_checkpoint, save_checkpoint

            ckpt = load_checkpoint(self.checkpoint_dir)
            if ckpt is not None and len(ckpt.sort_order) == len(reads):
                qp = ckpt.params
                prev_ll_with_prior = ckpt.prev_loglike_with_prior
                sort_order = ckpt.sort_order
                start_iter = ckpt.iteration
                log(f"Resuming from checkpoint at EM iteration {start_iter}")
            import jax

            if jax.process_count() > 1:
                # every host must resume the same EM state or the SPMD
                # mesh steps diverge silently: only host 0 writes the
                # checkpoint, so the dir must be on a shared filesystem
                import jax.numpy as jnp
                from jax.experimental import multihost_utils

                iters = multihost_utils.process_allgather(
                    jnp.asarray(start_iter, jnp.int32)
                )
                if int(iters.min()) != int(iters.max()):
                    raise RuntimeError(
                        "multi-host checkpoint resume desync: hosts see "
                        f"different EM iterations {sorted(set(int(i) for i in iters))} "
                        f"— -checkpoint dir '{self.checkpoint_dir}' must be "
                        "a shared filesystem visible to every host"
                    )
        for it in range(start_iter, self.max_iterations):
            if counts_provider is not None:
                counts, loglike, sort_order = counts_provider(qp, sort_order)
            else:
                counter = QuaffCounter(
                    qp, null_model, config, self.allow_null_model
                )
                counts, loglike, sort_order = counter.get_counts(
                    refs, reads, sort_order
                )
            from .parallel.distributed import is_primary

            primary = is_primary()  # only host 0 writes artifacts
            if self.raw_counts_filename and primary:
                with open(self.raw_counts_filename, "w") as f:
                    counts.write_json(f)
                    f.write("\n")
            log_prior = pseudocounts.log_prior(qp)
            ll_with_prior = loglike + log_prior
            log(
                f"EM iteration {it + 1}: log-likelihood ({loglike:g}) + "
                f"log-prior ({log_prior:g}) = {ll_with_prior:g}"
            )
            if it > 0 and ll_with_prior < prev_ll_with_prior + abs(
                prev_ll_with_prior
            ) * self.min_fractional_loglike_increment:
                break
            prev_ll_with_prior = ll_with_prior

            counts_with_prior = QuaffParamCounts.zero(
                qp.match_kmer_len, qp.indel_kmer_len
            )
            counts_with_prior.add_weighted(counts, 1.0)
            counts_with_prior.add_weighted(pseudocounts, 1.0)
            if self.counts_with_prior_filename and primary:
                with open(self.counts_with_prior_filename, "w") as f:
                    counts_with_prior.write_json(f)
                    f.write("\n")

            qp = counts_with_prior.fit()
            qp.fit_ref_seqs(refs)

            if self.save_params_filename and primary:
                with open(self.save_params_filename, "w") as f:
                    qp.write_json(f)
                    f.write("\n")
            if self.checkpoint_dir and primary:
                save_checkpoint(
                    self.checkpoint_dir,
                    TrainState(
                        params=qp,
                        iteration=it + 1,
                        prev_loglike_with_prior=prev_ll_with_prior,
                        sort_order=sort_order,
                    ),
                )
        return qp
