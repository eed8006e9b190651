"""High-level alignment pipeline: batched banded Viterbi + traceback.

Replaces the reference's QuaffAligner / QuaffAlignmentTask machinery
(src/qmodel.cpp:2624-2813): instead of one thread per read pulling tasks
from a mutex-guarded scheduler, each read's DP against all references is a
single batched device computation, and reads are processed in deterministic
order (the reference's single-thread output order, which its own
distributed tests assert).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import IO, List, Optional

import numpy as np

from .dp.engine import (
    PairBatch,
    device_batch,
    device_tables,
    dp_fill,
    pow2ceil,
)
from .dp.scores import ScoreTables
from .dp.traceback import viterbi_traceback
from . import device
from .device import batch_items, record_dispatch, warm
from .envelope import (
    DEFAULT_BAND_SIZE,
    DEFAULT_KMER_LENGTH,
    DEFAULT_KMER_THRESHOLD,
    Envelope,
    make_envelope,
)
from .formats.alignment import Alignment, AlignmentPrinter
from .io.fastseq import FastSeq, KmerIndex
from .model.params import QuaffNullParams, QuaffParams

# DP storage cost per cell used for the memory-fitted envelope threshold:
# 3 doubles for Viterbi, x2 for Forward-Backward (reference qmodel.h:384,
# qmodel.cpp:2249,2769)
VITERBI_CELL_SIZE = 24
FWDBACK_CELL_SIZE = 48


@dataclass
class DPConfig:
    """Execution configuration (the surviving subset of the reference's
    QuaffDPConfig, qmodel.h:280-352: banding parameters and DP mode; the
    socket/EC2/qsub fields are superseded by the device mesh)."""

    local: bool = True
    sparse: bool = True
    kmer_len: int = DEFAULT_KMER_LENGTH
    kmer_threshold: int = DEFAULT_KMER_THRESHOLD
    band_size: int = DEFAULT_BAND_SIZE
    max_size: int = 0
    auto_mem_size: bool = False
    threads: int = 1
    dtype: Optional[object] = None  # None -> f64 if jax x64 enabled else f32
    remotes: list = field(default_factory=list)  # [(addr, port), ...]
    # ssh-launched workers: [(user, addr, port, threads)]
    # (addRemote remoteJobs, qmodel.cpp:1087-1091); entries appear here
    # when -remote includes a user@ prefix (the reference ssh-launches
    # every -remote; we only auto-launch when credentials are given so
    # bare -remote host:port can target an already-running server)
    remote_jobs: list = field(default_factory=list)
    # ssh / rsync / S3 / EC2 control plane (parseGeneralConfigArgs,
    # qmodel.cpp:863-961 + aws.cpp:223-244)
    ssh_path: str = "ssh"
    rsync_path: str = "rsync"
    aws_path: str = "aws"
    ssh_key: str = ""
    use_rsync: bool = False
    bucket: str = ""
    ec2_ami: str = ""
    ec2_type: str = ""
    ec2_cores: int = 1
    ec2_user: str = "ec2-user"
    ec2_port: int = 8000
    ec2_instances: int = 0
    ec2_key: str = ""
    ec2_group: str = ""
    # files the workers must be able to open: [(tag, filename)]
    # (addFileArg, qmodel.cpp:1008-1016)
    file_args: list = field(default_factory=list)
    # qsub/NFS batch backend (component #24)
    qsub_jobs: int = 0
    qsub_path: str = "qsub"
    qsub_opts: str = ""
    qsub_header: str = "#!/bin/sh\n"
    qsub_dir: str = ""
    worker_path: str = ""  # remote/batch worker command (-remotepath)
    # device-mesh data parallelism (-mesh/-meshmp): shard the training
    # E-step pair grid over all attached devices (parallel/estep.py)
    use_mesh: bool = False
    mesh_mp: int = 1
    # multi-host runtime (-coordinator/-nprocs/-procid): every host runs
    # the same CLI command, jax.distributed wires them into one cluster,
    # and -mesh spans the GLOBAL device set (parallel/distributed.py)
    coordinator: str = ""
    n_procs: int = 0
    proc_id: int = -1

    def effective_max_size(self) -> int:
        return self.max_size // self.threads if self.auto_mem_size else self.max_size

    def make_envelope(self, x: FastSeq, y_index: KmerIndex, cell_size: int) -> Envelope:
        return make_envelope(
            x,
            y_index,
            sparse=self.sparse,
            band_size=self.band_size,
            kmer_threshold=self.kmer_threshold,
            cell_size=cell_size,
            max_size=self.effective_max_size(),
        )

    def resolve_dtype(self):
        if self.dtype is not None:
            return self.dtype
        import jax
        import jax.numpy as jnp

        return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


class QuaffAligner:
    """Viterbi alignment of reads against references.

    For each read, all (ref, read) band fills run as one batched device
    call; the winner's band is walked back on the host.
    """

    def __init__(
        self,
        params: QuaffParams,
        null_model: QuaffNullParams,
        config: DPConfig,
        print_all: bool = False,
    ):
        self.params = params
        self.null_model = null_model
        self.config = config
        self.print_all = print_all
        self.tables = ScoreTables.from_params(params)
        self._tdev_cache = None
        # -mesh: device mesh for sharded batch scoring (set by the CLI;
        # winner tracebacks stay host-side either way)
        self.mesh = None

    @property
    def _tdev(self):
        """Engine device tables, built on first use: building them at
        construction would initialise the backend and upload tables that
        a native small-workload run never touches (time-to-first-result)."""
        if self._tdev_cache is None:
            self._tdev_cache = device_tables(self.tables)
        return self._tdev_cache

    def _use_fast_scores(self) -> bool:
        """Where the device scorers run, rank candidate refs with the
        align kernel and compute only the winners' tracebacks in f64 on
        the host; on the CPU the host fills are both fast and the parity
        path."""
        return device.device_scorers()

    def _score_chunk(self, pairs, width=None, max_y_len=None):
        """Device Viterbi scores of (ref, read, envelope) pairs, lane-packed
        into one kernel batch.  Returns the unfetched device arrays (pair
        scores [B], per-strip scores [B, S] in pack_strips order)."""
        from .dp import align_kernel

        batch = PairBatch.build_packed(
            pairs, self.tables, width=width, max_y_len=max_y_len
        )
        record_dispatch("align")
        return align_kernel.viterbi_scores(
            self._tdev, device_batch(batch), local=self.config.local,
            reach=align_kernel.scan_reach(batch.seg_width),
            return_segments=True,
        )

    def align_read(self, refs: List[FastSeq], y: FastSeq) -> List[Alignment]:
        """Align one read against all refs; returns the best alignment (or
        all finite ones if print_all), null-model-adjusted, sorted by
        descending score (ties keep reference order)."""
        import jax

        y_index = KmerIndex(y, self.config.kmer_len)
        envs = [
            self.config.make_envelope(x, y_index, VITERBI_CELL_SIZE) for x in refs
        ]
        # Time-to-first-result: while the align kernel is cold in this
        # process, a small workload's whole score pass runs natively on
        # the host (f64, bitwise engine parity) instead of paying the
        # backend start-up and the kernel's compilation.  Decide the
        # under-budget route (QUAFF_NATIVE_SMALL_CELLS member cells, 0
        # disables) BEFORE calling _use_fast_scores, whose
        # jax.default_backend() starts the backend; the winner traceback
        # below is host-native either way.  The picks can only get MORE
        # reference-faithful: f64 ranking instead of the f32 kernel's.
        scores = None
        fast = True
        budget = int(
            os.environ.get("QUAFF_NATIVE_SMALL_CELLS", "40000000")
        )
        if (
            budget
            and not warm("align")  # a warm kernel beats native
            and (jax.config.jax_platforms or "") != "cpu"  # no init
            and sum(e.num_cells for e in envs) * 2 <= budget
        ):
            from .native import align_score_native

            batch = PairBatch.build(
                [(x, y, e) for x, e in zip(refs, envs)], self.tables
            )
            s = align_score_native(
                batch, self.tables, mode="viterbi",
                local=self.config.local,
            )
            if s is not None:
                scores = np.asarray(s, dtype=np.float64)
        if scores is None:
            fast = self._use_fast_scores()
        if fast:
            if scores is None:
                # lane-packed strips: multi-cluster envelopes cost their
                # member lanes, not their bounding band
                scores = np.asarray(
                    self._score_chunk(
                        [(x, y, e) for x, e in zip(refs, envs)]
                    )[0],
                    dtype=np.float64,
                )
        else:
            batch = PairBatch.build(
                [(x, y, e) for x, e in zip(refs, envs)], self.tables
            )
            res = dp_fill(
                self._tdev,
                device_batch(batch),
                mode="viterbi",
                local=self.config.local,
                return_matrices=True,
                dtype=self.config.resolve_dtype(),
            )
            scores = np.asarray(res["score"], dtype=np.float64)

        null_ll = self.null_model.log_likelihood(y)

        if self.print_all:
            picks = [nx for nx in range(len(refs)) if math.isfinite(scores[nx])]
        else:
            best: Optional[int] = None
            for nx in range(len(refs)):
                if math.isfinite(scores[nx]) and (
                    best is None or scores[nx] > scores[best]
                ):
                    best = nx
            picks = [] if best is None else [best]

        if fast:
            # winners only: banded fill with matrices on the CPU backend
            if not picks:
                return []
            from .precision import x64_scope

            cpu = jax.devices("cpu")[0]
            wbatch = PairBatch.build(
                [(refs[nx], y, envs[nx]) for nx in picks], self.tables
            )
            from .native import align_fill_native

            res = align_fill_native(
                wbatch, self.tables, mode="viterbi", local=self.config.local
            )
            if res is None:
                with x64_scope(), jax.default_device(cpu):
                    wdev = {
                        k: jax.device_put(v, cpu)
                        for k, v in device_batch(wbatch).items()
                    }
                    # rebuild tables in f64 inside the scope: the cached
                    # device tables were materialised in 32-bit mode on the
                    # accelerator
                    wtab = device_tables(self.tables)
                    res = dp_fill(
                        wtab,
                        wdev,
                        mode="viterbi",
                        local=self.config.local,
                        return_matrices=True,
                        dtype=self.config.resolve_dtype(),
                    )
            scores_w = np.asarray(res["score"], dtype=np.float64)
            mats = np.asarray(res["mat"])
            inss = np.asarray(res["ins"])
            dels = np.asarray(res["del"])
            index_of = {nx: i for i, nx in enumerate(picks)}
        else:
            mats = np.asarray(res["mat"])
            inss = np.asarray(res["ins"])
            dels = np.asarray(res["del"])
            scores_w = scores
            index_of = {nx: nx for nx in picks}

        out: List[Alignment] = []
        from .logger import logger

        for nx in picks:
            i = index_of[nx]
            if logger.logging_tag("dpmatrix"):
                # `-log dpmatrix` cell dump (QuaffViterbiMatrix,
                # qmodel.cpp:1558-1559)
                from .dp.debug import write_dp_matrix

                write_dp_matrix(
                    refs[nx], y, envs[nx],
                    mats[i], inss[i], dels[i], float(scores_w[i]),
                )
            a = viterbi_traceback(
                refs[nx],
                y,
                envs[nx],
                self.tables,
                mats[i],
                inss[i],
                dels[i],
                float(scores_w[i]),
                local=self.config.local,
            )
            a.score -= null_ll
            out.append(a)
        out.sort(key=lambda a: -a.score)
        return out

    def _mesh_chunk_scores(self, mesh_chunks, refs, reads, fast, scores):
        """-mesh phase B: score chunks D at a time inside shard_map over
        the device mesh — the mesh analogue of farming one read-task
        per worker (runQuaffAlignmentTasks, qmodel.cpp:2870-2882).  Pair
        chunks shard over the dp axis, score tables replicate, no
        collective is needed; scores are allgathered to every host of a
        multi-host cluster.  Chunks are grouped by identical padded shape
        (quality mode, width, rows, padded batch) so every device runs
        one program; short groups repeat their last chunk (the extra
        scores are discarded)."""
        from jax.sharding import PartitionSpec as P

        from .dp.engine import host_batch
        from .parallel.distributed import global_array
        from .parallel.estep import (
            gather_scores,
            sharded_align_engine,
            sharded_align_scores,
        )

        D = self.mesh.devices.size
        # every chunk in a group must produce identically-shaped arrays
        # for the [D, ...] stack: the ref-axis padding is pinned to the
        # global max ref length (chunks do not all contain the longest
        # ref)
        lx = max(len(x.seq) for x in refs)
        groups: dict = {}
        for hq, wp, lp, chunk in mesh_chunks:
            groups.setdefault((hq, wp, lp, pow2ceil(len(chunk))), []).append(
                chunk
            )
        tdev_g = None
        for (hq, wp, lp, bq), glist in sorted(groups.items()):
            for g0 in range(0, len(glist), D):
                gset = glist[g0 : g0 + D]
                padded = gset + [gset[-1]] * (D - len(gset))
                build = PairBatch.build_packed if fast else PairBatch.build
                stacked_src = []
                for chunk in padded:
                    pairs = [
                        (refs[nx], reads[ny], env) for ny, nx, env in chunk
                    ]
                    pairs.extend([pairs[-1]] * (bq - len(pairs)))
                    stacked_src.append(
                        host_batch(
                            build(
                                pairs, self.tables, width=wp,
                                max_y_len=lp, max_x_len=lx,
                            )
                        )
                    )
                stacked = {
                    k: global_array(
                        self.mesh, P("dp"),
                        np.stack([d[k] for d in stacked_src]),
                    )
                    for k in stacked_src[0]
                }
                if tdev_g is None:
                    tdev_g = {
                        k: global_array(self.mesh, P(), v)
                        for k, v in self._tdev.items()
                    }
                if fast:
                    from .dp.align_kernel import scan_reach

                    record_dispatch("align")
                    s = sharded_align_scores(
                        self.mesh, tdev_g, stacked, local=self.config.local,
                        reach=scan_reach(
                            [d["seg_width"] for d in stacked_src]
                        ),
                    )
                else:
                    s = sharded_align_engine(
                        self.mesh, tdev_g, stacked, mode="viterbi",
                        local=self.config.local,
                        dtype=self.config.resolve_dtype(),
                    )
                s = gather_scores(s)
                for chunk, srow in zip(gset, np.asarray(s, np.float64)):
                    for (ny, nx, env), sc in zip(chunk, srow):
                        scores[(ny, nx)] = (float(sc), env, None)

    def align_all(
        self,
        out: IO[str],
        refs: List[FastSeq],
        reads: List[FastSeq],
        printer: AlignmentPrinter,
    ) -> None:
        """The `quaff align` driver: header, then per-read best alignments
        in read order (qmodel.cpp:2624-2646).

        Multiple reads are scored in large cross-read device batches
        (bucketed by padded band width and read length to bound
        recompilations); only the winning pairs are re-filled with
        matrices for traceback."""
        from .logger import ProgressLogger

        plog = ProgressLogger(level=2)
        plog.init_progress("Alignment")
        printer.write_header(out, refs, group_by_query=True)
        # small workloads skip the batched pipeline: align_read's
        # native under-budget gate then answers one-shot invocations
        # without paying the process's first device dispatch
        # (time-to-first-result; the per-read cell budget still sends
        # long reads to the kernel)
        import jax

        small_pairs = int(os.environ.get("QUAFF_NATIVE_SMALL_PAIRS", "32"))
        # decided from the configured platform, not jax.default_backend(),
        # which would start the backend this route exists to avoid.
        # CPU-pinned runs (JAX_PLATFORMS=cpu) keep the batched engine path.
        cpu_pinned = (jax.config.jax_platforms or "") == "cpu"
        if len(reads) <= 1 or (
            self.mesh is None
            and not cpu_pinned
            and not warm("align")  # a warm kernel: the pipeline wins
            and len(reads) * max(len(refs), 1) <= small_pairs
        ):
            for y in reads:
                for a in self.align_read(refs, y):
                    printer.write_alignment(out, a)
            plog.done()
            return

        per_read = self._align_batched(refs, reads, plog)
        for ny in range(len(reads)):
            for a in per_read.get(ny, []):
                printer.write_alignment(out, a)
        plog.done()

    def _align_batched(self, refs, reads, plog, max_batch: int = 2048):
        import jax

        def round_up(v, m):
            return ((v + m - 1) // m) * m

        # phase A: envelopes for every (read, ref) pair.  -threads N
        # parallelises this host-side prep over reads (k-mer index +
        # per-ref envelope are numpy-heavy and independent; order stays
        # read-major so downstream output is unchanged)
        # long-band guard (kernel path only): a pair whose packed width
        # exceeds the lane cap is re-banded with the memory-fitted walk
        # (fit_envelope_lanes — the reference's diagenv.cpp:60-106 with
        # the device cost model); on long noisy reads the fixed seed
        # threshold admits spurious clusters scattered across the whole
        # diagonal range.  The cap (4096 lanes, ~20x the widest committed
        # workload, and the kernel's widest block) bounds work, not
        # memory: at 50 kb reads the unfitted noise lanes made scoring
        # and winner fills cost minutes per read, while the fitted walk
        # keeps the same winning paths.
        lane_cap = int(os.environ.get("QUAFF_ALIGN_LANE_CAP", "4096"))
        guard = self.config.sparse and self._use_fast_scores()
        from .envelope import fit_envelope_lanes, pack_strips

        def _read_jobs(ny):
            y_index = KmerIndex(reads[ny], self.config.kmer_len)
            js = []
            for nx, x in enumerate(refs):
                env = self.config.make_envelope(x, y_index, VITERBI_CELL_SIZE)
                if guard and (
                    sum(s.band_width for s in pack_strips(env)) > lane_cap
                ):
                    env = fit_envelope_lanes(
                        x, y_index, lane_cap,
                        band_size=self.config.band_size,
                        kmer_threshold=max(self.config.kmer_threshold, 0),
                    )
                js.append((ny, nx, env))
            return js

        jobs = []  # (ny, nx, env)
        if self.config.threads > 1 and len(reads) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(self.config.threads) as ex:
                for js in ex.map(_read_jobs, range(len(reads))):
                    jobs.extend(js)
        else:
            for ny in range(len(reads)):
                jobs.extend(_read_jobs(ny))

        # phase B: bucketed batch scoring (kernel batches must be
        # homogeneous in quality presence, so it joins the bucket key).
        # Kernel batches use the lane-packed strip layout, so the bucket
        # width key is the packed width (Σ strip widths), not the
        # bounding-band width.
        fast = self._use_fast_scores()
        if fast:
            from .envelope import pack_strips

            def kernel_width(env):
                return sum(s.band_width for s in pack_strips(env))
        else:
            def kernel_width(env):
                return env.band_width

        # Greedy row-merged chunking (longest reads first) per
        # quality-presence group: the kernel cost is dominated by its
        # row loop, and every distinct (B, width, rows) shape is a fresh
        # compile — so chunks merge mixed lengths at the chunk-max padded
        # shape (stopping when padding waste exceeds one extra full row
        # scan), take the max packed width, and pad the batch size to a
        # power-of-two quantum with repeated trailing pairs (their scores
        # are discarded).
        groups: dict = {}
        for job in jobs:
            ny, nx, env = job
            groups.setdefault(reads[ny].has_qual(), []).append(job)

        # device batch budget: pairs per chunk under the memory limit
        # for the kernel's per-pair footprint at the chunk's shape
        # (max_batch bounds the work of one dispatch)
        lx = max(len(x.seq) for x in refs)

        from .dp.align_kernel import bytes_per_pair

        def max_pairs(wp, lp):
            return batch_items(bytes_per_pair(wp, lp, lx), max_batch)

        chunks = []
        for hq, js in sorted(groups.items()):
            js.sort(key=lambda j: -len(reads[j[0]].seq))
            i = 0
            while i < len(js):
                lp = round_up(len(reads[js[i][0]].seq), 512)
                chunk = [js[i]]
                wmax = round_up(max(kernel_width(js[i][2]), 128), 128)
                i += 1
                waste = 0
                while i < len(js) and len(chunk) < max_batch:
                    w_j = lp - round_up(len(reads[js[i][0]].seq), 512)
                    wm = max(
                        wmax,
                        round_up(max(kernel_width(js[i][2]), 128), 128),
                    )
                    if (
                        waste + w_j > lp
                        or pow2ceil(len(chunk) + 1) > max_pairs(wm, lp)
                    ):
                        break
                    waste += w_j
                    wmax = wm
                    chunk.append(js[i])
                    i += 1
                chunks.append((hq, wmax, lp, chunk))

        scores = {}  # (ny, nx) -> (score, env, per-strip kernel scores|None)
        n_done = 0
        mesh_chunks = []  # -mesh: same-shape chunks scored D-at-a-time
        remaining = [0] * len(reads)  # unscored pairs per read
        for ny, nx, env in jobs:
            remaining[ny] += 1

        # ---- phase C machinery: winner strip fills + tracebacks ----
        # Runs CONCURRENTLY with phase B (the round-2 architecture ran it
        # strictly after, leaving the device idle ~98% of align wall —
        # the reference's per-read task threads overlap fill and output
        # trivially, qmodel.cpp:2624-2646).  As each scored chunk drains,
        # reads whose pairs are all scored emit winner jobs immediately;
        # jobs accumulate into footprint-capped fill chunks submitted to
        # a worker pool (the native f64 fill and traceback release the
        # GIL).  Every worker output carries a (read, candidate-rank)
        # sequence tag, and results are merged in tag order, so output
        # bytes are independent of thread scheduling AND of chunk
        # grouping (each pair's padded fill is bitwise independent of
        # its chunk-mates).
        import threading
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        from .envelope import pack_strips
        from .native import align_fill_native
        from .precision import x64_scope

        # Per-strip f64 refill scope: only strips whose f32 kernel score
        # is within this margin (nats) of the pair's best strip are
        # refilled for the winner traceback — the same bound the overlap
        # exact pass uses (the kernel's f32 error is held far below it:
        # see dp/align_kernel's per-row rebasing, so the true f64-best
        # strip is always in scope).  Non-kernel scoring paths fill all
        # strips.
        strip_margin = 1.0

        cpu = jax.devices("cpu")[0]
        null_cache = {}
        null_lock = threading.Lock()
        wtab = None
        wtab_lock = threading.Lock()

        def null_ll(ny):
            v = null_cache.get(ny)
            if v is None:
                v = self.null_model.log_likelihood(reads[ny])
                with null_lock:
                    null_cache[ny] = v
            return v

        def fill(entries):
            wbatch = PairBatch.build(entries, self.tables)
            # each pool worker fills its chunk serially (the pool itself
            # is the parallelism — a per-fill inner pool just
            # oversubscribes the cores) and reuses its thread-local
            # output arenas (fill_and_walk consumes the matrices before
            # the worker takes another chunk)
            import os as _os

            res = align_fill_native(
                wbatch, self.tables, mode="viterbi",
                local=self.config.local,
                threads=max(1, (_os.cpu_count() or 1) // T),
                reuse_buffers=True,
            )
            if res is not None:
                return res
            nonlocal wtab
            with wtab_lock, x64_scope(), jax.default_device(cpu):
                if wtab is None:
                    wtab = device_tables(self.tables)
                wdev = {
                    k: jax.device_put(v, cpu)
                    for k, v in device_batch(wbatch).items()
                }
                res = dp_fill(
                    wtab, wdev, mode="viterbi", local=self.config.local,
                    return_matrices=True,
                    dtype=self.config.resolve_dtype(),
                )
            return {k: np.asarray(v) for k, v in res.items()}

        from .dp.traceback import viterbi_path_traceback
        from .native import align_path_available, align_score_native
        # one checkpointed native call per winner (fill + walk fused, no
        # DP matrices): ~3x the matrix fill's throughput (the full-
        # matrix fill is store-bandwidth-bound at 3*(R+1)*W doubles per
        # strip).  Falls back to the matrix fill when the library is
        # not built.
        use_path = align_path_available()

        def fill_and_walk(chunk):
            """One worker unit: resolve each winner's best strip in f64
            and walk its traceback.  chunk: [(seq, ny, nx, strips)]."""
            out = []
            if use_path:
                for seq, ny, nx, strips in chunk:
                    if len(strips) > 1:
                        # matrix-free score fills pick the f64-best strip
                        # (bitwise equal to the full fill's scores; first
                        # strict max, like the matrix path's scan)
                        wb = PairBatch.build(
                            [(refs[nx], reads[ny], s) for s in strips],
                            self.tables,
                        )
                        sc = align_score_native(
                            wb, self.tables, mode="viterbi",
                            local=self.config.local, threads=1,
                        )
                        strip = strips[int(np.argmax(sc))]
                    else:
                        strip = strips[0]
                    a = viterbi_path_traceback(
                        refs[nx], reads[ny], strip, self.tables,
                        local=self.config.local,
                    )
                    a.score -= null_ll(ny)
                    out.append((seq, ny, a))
                return out
            entries = [
                (refs[nx], reads[ny], s)
                for _, ny, nx, ss in chunk
                for s in ss
            ]
            res = fill(entries)
            b = 0
            for seq, ny, nx, strips in chunk:
                best_b = b
                best_sc = float(res["score"][b])
                for k in range(1, len(strips)):
                    sc = float(res["score"][b + k])
                    if sc > best_sc:
                        best_b, best_sc = b + k, sc
                a = viterbi_traceback(
                    refs[nx], reads[ny], strips[best_b - b], self.tables,
                    res["mat"][best_b], res["ins"][best_b],
                    res["del"][best_b], best_sc,
                    local=self.config.local,
                )
                a.score -= null_ll(ny)
                out.append((seq, ny, a))
                b += len(strips)
            return out

        # PairBatch.build pads every entry to the chunk max (rows,
        # width), so the footprint cap tracks the PADDED element count;
        # in-flight futures are windowed so at most T+1 chunks' f64
        # matrices exist at once.  Smaller chunks balance the worker
        # pool and interleave with device draining at the cost of
        # per-chunk build overhead (measured optimum on this 4-core
        # host: ~6M elems = ~13 full-length c8f30 winners per chunk).
        max_elems = int(os.environ.get("QUAFF_WINNER_CHUNK_ELEMS",
                                       "6000000"))
        T = max(1, self.config.threads)
        pool = ThreadPoolExecutor(T)
        futures = deque()
        collected = []  # (seq, ny, alignment)
        cbuf = []
        cb_strips = cb_w = cb_r = 0

        def flush():
            nonlocal cbuf, cb_strips, cb_w, cb_r
            if not cbuf:
                return
            chunk, cbuf = cbuf, []
            cb_strips = cb_w = cb_r = 0
            while len(futures) > T:
                collected.extend(futures.popleft().result())
            futures.append(pool.submit(fill_and_walk, chunk))

        def add_winner(seq, ny, nx, env, segs):
            nonlocal cb_strips, cb_w, cb_r
            strips = pack_strips(env, 3)
            if segs is not None and len(strips) > 1:
                best = max(float(v) for v in segs[: len(strips)])
                strips = [
                    s for k, s in enumerate(strips)
                    if float(segs[k]) >= best - strip_margin
                ]
            w_j = max(s.band_width for s in strips)
            r_j = len(reads[ny].seq) + 1
            padded = (
                (cb_strips + len(strips)) * max(cb_r, r_j) * max(cb_w, w_j)
            )
            if cbuf and padded > max_elems:
                flush()
            cbuf.append((seq, ny, nx, strips))
            cb_strips += len(strips)
            cb_w = max(cb_w, w_j)
            cb_r = max(cb_r, r_j)

        def emit_read(ny):
            """All of read ny's pairs are scored: queue its winner(s)."""
            cands = [
                (nx,) + scores[(ny, nx)] for nx in range(len(refs))
                if math.isfinite(scores[(ny, nx)][0])
            ]
            if not cands:
                return
            if self.print_all:
                for rank, (nx, sc, env, segs) in enumerate(cands):
                    add_winner((ny, rank), ny, nx, env, segs)
            else:
                best_nx, best_sc, best_env, best_segs = cands[0]
                for nx, sc, env, segs in cands[1:]:
                    if sc > best_sc:
                        best_nx, best_sc, best_env, best_segs = (
                            nx, sc, env, segs
                        )
                add_winner((ny, 0), ny, best_nx, best_env, best_segs)

        def record_chunk(chunk, s, segs):
            nonlocal n_done
            for i, (ny, nx, env) in enumerate(chunk):
                scores[(ny, nx)] = (
                    float(s[i]), env, None if segs is None else segs[i]
                )
                remaining[ny] -= 1
                # -mesh defers all emission to after the primary check
                if remaining[ny] == 0 and self.mesh is None:
                    emit_read(ny)
            n_done += len(chunk)
            plog.log_progress(
                n_done / len(jobs), f"{n_done}/{len(jobs)} pairs scored"
            )

        # ---- phase B: dispatch kernel chunks ahead (deferred fetch),
        # drain in order — the device fills chunk i+1 while the host
        # walks chunk i's winners.
        from .dp.align_kernel import MAX_LANES

        inflight = deque()  # (chunk, (pair scores, strip scores) on device)
        max_inflight = 4

        def drain_one():
            chunk, (dev_s, dev_segs) = inflight.popleft()
            s = np.asarray(dev_s, dtype=np.float64)
            record_chunk(chunk, s, np.asarray(dev_segs, dtype=np.float64))

        for hq, wp, lp, chunk in chunks:
                wide = fast and wp > MAX_LANES
                if self.mesh is not None and not wide:
                    mesh_chunks.append((hq, wp, lp, chunk))
                    continue
                B = len(chunk)
                bq = pow2ceil(B)
                pairs = [
                    (refs[nx], reads[ny], env) for ny, nx, env in chunk
                ]
                if bq > B:
                    pairs.extend([pairs[-1]] * (bq - B))
                if wide:
                    # pathological envelope (a merged seed cluster tens of
                    # thousands of diagonals wide), wider than the
                    # kernel's widest block.  On a device mesh the band's
                    # LANES shard across the devices instead
                    # (parallel/spfill — SURVEY §5.7's sequence-parallel
                    # extension: per-row halo ppermute + distributed
                    # prefix scan for the delete state, exact scores);
                    # single-device runs score with the host engine.
                    if self.mesh is not None:
                        from jax.sharding import Mesh as _Mesh

                        from .parallel.spfill import sp_fill_scores

                        devs = self.mesh.devices.reshape(-1)
                        S = len(devs)
                        wb = max(e.band_width for _, _, e in pairs)
                        wsp = ((wb + S - 1) // S) * S
                        sp_batch = PairBatch.build(
                            pairs, self.tables, width=wsp, max_y_len=lp
                        )
                        sp_mesh = _Mesh(np.array(devs), ("sp",))
                        s = np.asarray(
                            sp_fill_scores(
                                sp_mesh, self._tdev,
                                device_batch(sp_batch),
                                mode="viterbi", local=self.config.local,
                                dtype=self.config.resolve_dtype(),
                            ),
                            dtype=np.float64,
                        )[: len(chunk)]
                        s = np.where(np.isfinite(s), s, -np.inf)
                        record_chunk(chunk, s, None)
                        continue
                    with x64_scope(), jax.default_device(cpu):
                        wide_tab = device_tables(self.tables)
                        wdev = {
                            k: jax.device_put(v, cpu)
                            for k, v in device_batch(
                                PairBatch.build(
                                    pairs[: len(chunk)], self.tables
                                )
                            ).items()
                        }
                        s = np.asarray(
                            dp_fill(
                                wide_tab, wdev, mode="viterbi",
                                local=self.config.local,
                                return_matrices=False,
                                dtype=self.config.resolve_dtype(),
                            )["score"],
                            dtype=np.float64,
                        )
                    record_chunk(chunk, s, None)
                elif fast:
                    inflight.append(
                        (chunk, self._score_chunk(pairs, wp, lp))
                    )
                    if len(inflight) >= max_inflight:
                        drain_one()
                else:
                    batch = PairBatch.build(
                        pairs, self.tables, width=wp, max_y_len=lp
                    )
                    # CPU scoring: the native score-only fill (no matrices
                    # stored; bitwise-equal Viterbi scores) beats the XLA
                    # scan
                    from .native import align_score_native

                    s = align_score_native(
                        batch, self.tables, mode="viterbi",
                        local=self.config.local,
                    )
                    if s is None:
                        s = np.asarray(
                            dp_fill(
                                self._tdev, device_batch(batch),
                                mode="viterbi", local=self.config.local,
                                return_matrices=False,
                                dtype=self.config.resolve_dtype(),
                            )["score"],
                            dtype=np.float64,
                        )
                    record_chunk(chunk, s, None)
        while inflight:
            drain_one()
        if mesh_chunks:
            self._mesh_chunk_scores(mesh_chunks, refs, reads, fast, scores)
            plog.log_progress(1.0, f"{len(jobs)}/{len(jobs)} pairs scored")

        # -mesh: emission was deferred (scores arrive via allgather);
        # only host 0 of a multi-host cluster writes output, so the
        # other hosts stop here (phase B's shard_map/allgather are the
        # last collectives; winner fills are pure host work)
        if self.mesh is not None:
            from .parallel.distributed import is_primary

            if not is_primary():
                pool.shutdown(wait=False)
                return {}
            for ny in range(len(reads)):
                emit_read(ny)

        flush()
        while futures:
            collected.extend(futures.popleft().result())
        pool.shutdown()

        # merge in (read, candidate-rank) tag order — byte-identical to
        # the sequential read-major walk regardless of thread timing
        collected.sort(key=lambda t: t[0])
        per_read: dict = {}
        for seq, ny, a in collected:
            per_read.setdefault(ny, []).append(a)
        for ny in per_read:
            per_read[ny].sort(key=lambda a: -a.score)
        return per_read
