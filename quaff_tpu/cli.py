"""quaff-compatible command-line driver.

Mirrors the reference CLI (t/quaff.cpp:104-326): commands train / align /
overlap / count / server, the same flag surface (chain-parsed from an
argument deque, with bare filenames becoming implicit -ref/-read switches,
src/optparser.cpp:32-54), and load-or-derive semantics for params, null
model and prior.
"""

from __future__ import annotations

import sys
from collections import deque
from typing import List, Optional

PROG = "quaff-tpu"
VERSION = "0.1"

DEFAULT_REFSEQ_KMER_THRESHOLD = 20  # align/train (t/quaff.cpp:15)


def _fail(msg: str) -> "NoReturn":
    sys.stderr.write(msg + "\n")
    sys.exit(1)


def _need_arg(args: deque, flag: str) -> str:
    if len(args) < 2:
        _fail(f"{flag} must have an argument")
    args.popleft()
    return args.popleft()


class SeqListArgs:
    """-ref/-read accumulation with -fwdstrand/-noquals (SeqList,
    t/quaff.cpp:21-49)."""

    def __init__(self, tag: str, want_quals: bool, want_revcomps: bool):
        self.tag = tag
        self.filenames: List[str] = []
        self.filepos: List[int] = []
        self.want_quals = want_quals
        self.want_revcomps = want_revcomps

    def parse(self, args: deque) -> bool:
        if not args:
            return False
        arg = args[0]
        if arg == self.tag:
            self.filenames.append(_need_arg(args, arg))
            self.filepos.append(-1)
            return True
        if arg == self.tag + "index":
            if len(args) < 3:
                _fail(f"{arg} needs two arguments")
            args.popleft()
            self.filenames.append(args.popleft())
            self.filepos.append(int(args.popleft()))
            return True
        if arg == "-fwdstrand":
            self.want_revcomps = False
            args.popleft()
            return True
        return False

    def parse_noquals(self, args: deque) -> bool:
        if args and args[0] == "-noquals":
            self.want_quals = False
            args.popleft()
            return True
        return False

    def load(self, require_quals_ok: bool = True, check_duplicates: bool = False):
        from .io.fastseq import (
            add_revcomps,
            duplicate_names,
            read_fast_seqs,
            read_indexed_fast_seq,
        )

        if not self.filenames:
            _fail(f"Please specify at least one sequence file using {self.tag}")
        seqs = []
        for fn, pos in zip(self.filenames, self.filepos):
            if pos < 0:
                recs = read_fast_seqs(fn)
            else:
                recs = [read_indexed_fast_seq(fn, pos)]
            for fs in recs:
                if self.want_quals:
                    if not fs.has_qual():
                        _fail(
                            f"Sequence {fs.name} in file {fn} does not have"
                            " quality scores"
                        )
                else:
                    fs.qual = ""
                if len(fs.seq):
                    seqs.append(fs)
        n_originals = len(seqs)
        if self.want_revcomps:
            seqs = add_revcomps(seqs)
        if not seqs:
            _fail(f"Please specify a valid sequence file using {self.tag}")
        if check_duplicates:
            dups = duplicate_names(seqs)
            if dups:
                _fail(
                    "Duplicate names: "
                    + " ".join(sorted(dups))
                    + "\nAll sequence names are required to be unique"
                )
        return seqs, n_originals


def _parse_dp_config(args: deque, config, general_only: bool = False) -> bool:
    """-kmatch*/-global/-threads parsing (QuaffDPConfig::parse*ConfigArgs,
    qmodel.cpp:746-1012)."""
    if not args:
        return False
    arg = args[0]
    if arg == "-global" and not general_only:
        config.local = False
        args.popleft()
        return True
    if arg == "-kmatchband":
        config.band_size = int(_need_arg(args, arg))
        return True
    if arg == "-kmatch":
        k = int(_need_arg(args, arg))
        if not (5 <= k <= 32):
            _fail(f"-kmatch out of range ({k}). Try 5 to 32")
        config.kmer_len = k
        return True
    if arg == "-kmatchn":
        config.kmer_threshold = int(_need_arg(args, arg))
        return True
    if arg == "-kmatchmb":
        config.max_size = int(_need_arg(args, arg)) << 20
        if config.max_size == 0:
            # -kmatchmb 0 falls back to physical memory
            # (qmodel.cpp:789-793)
            from .memsize import get_memory_size

            config.max_size = get_memory_size()
        config.kmer_threshold = -1
        config.auto_mem_size = False
        return True
    if arg == "-kmatchmax":
        # physical RAM (memsize.cpp equivalent, cross-platform)
        from .memsize import get_memory_size

        config.max_size = get_memory_size()
        config.kmer_threshold = -1
        config.auto_mem_size = True
        args.popleft()
        return True
    if arg == "-kmatchoff":
        config.sparse = False
        args.popleft()
        return True
    if arg == "-threads":
        config.threads = int(_need_arg(args, arg))
        return True
    if arg == "-remote":
        import re

        spec = _need_arg(args, arg)
        m = re.fullmatch(r"(?:([^@]+)@)?([-A-Za-z0-9.]+)(?::(\d+)(?:-(\d+))?)?", spec)
        if not m:
            _fail(f"Can't parse server address: {spec}")
        user = m.group(1) or ""
        addr = m.group(2)
        lo = int(m.group(3)) if m.group(3) else 8000
        hi = int(m.group(4)) if m.group(4) else lo
        if user:
            # credentials given: ssh-launch a worker server there
            # (addRemote, qmodel.cpp:943-955/1087-1091)
            config.remote_jobs.append((user, addr, lo, hi + 1 - lo))
        else:
            for port in range(lo, hi + 1):
                config.remotes.append((addr, port))
        return True
    if arg == "-sshpath":
        config.ssh_path = _need_arg(args, arg)
        return True
    if arg == "-rsyncpath":
        config.rsync_path = _need_arg(args, arg)
        return True
    if arg == "-awspath":
        config.aws_path = _need_arg(args, arg)
        return True
    if arg == "-sshkey":
        config.ssh_key = _need_arg(args, arg)
        return True
    if arg == "-rsync":
        config.use_rsync = True
        args.popleft()
        return True
    if arg == "-s3bucket":
        config.bucket = _need_arg(args, arg)
        return True
    if arg == "-ec2ami":
        config.ec2_ami = _need_arg(args, arg)
        return True
    if arg == "-ec2type":
        config.ec2_type = _need_arg(args, arg)
        return True
    if arg == "-ec2cores":
        config.ec2_cores = int(_need_arg(args, arg))
        return True
    if arg == "-ec2user":
        config.ec2_user = _need_arg(args, arg)
        return True
    if arg == "-ec2port":
        config.ec2_port = int(_need_arg(args, arg))
        return True
    if arg == "-ec2instances":
        config.ec2_instances = int(_need_arg(args, arg))
        return True
    if arg == "-ec2key":
        config.ec2_key = _need_arg(args, arg)
        return True
    if arg == "-ec2group":
        config.ec2_group = _need_arg(args, arg)
        return True
    if arg == "-maxthreads":
        import os

        config.threads = os.cpu_count() or 1
        args.popleft()
        return True
    if arg == "-qsubjobs":
        config.qsub_jobs = int(_need_arg(args, arg))
        return True
    if arg in ("-qsubpath", "-qsub"):
        config.qsub_path = _need_arg(args, arg)
        return True
    if arg == "-qsubopts":
        config.qsub_opts += _need_arg(args, arg)
        return True
    if arg == "-qsubdir":
        config.qsub_dir = _need_arg(args, arg)
        return True
    if arg == "-qsubheader":
        config.qsub_header = open(_need_arg(args, arg)).read()
        return True
    if arg == "-remotepath":
        config.worker_path = _need_arg(args, arg)
        return True
    if arg == "-mesh":
        config.use_mesh = True
        args.popleft()
        return True
    if arg == "-meshmp":
        config.mesh_mp = int(_need_arg(args, arg))
        config.use_mesh = True
        return True
    # multi-host runtime flags (consumed for config bookkeeping; the
    # actual jax.distributed.initialize happened in main() before the
    # backend came up — see _peek_distributed_args)
    if arg == "-coordinator":
        config.coordinator = _need_arg(args, arg)
        return True
    if arg == "-nprocs":
        config.n_procs = int(_need_arg(args, arg))
        return True
    if arg == "-procid":
        config.proc_id = int(_need_arg(args, arg))
        return True
    return False


def _parse_printer(args: deque, printer, state) -> bool:
    """-format/-threshold/-nothreshold/-savealign
    (parseAlignmentPrinterArgs, qmodel.cpp:2485-2529)."""
    from .formats.alignment import OutputFormat

    if not args:
        return False
    arg = args[0]
    if arg == "-format":
        fmt = _need_arg(args, arg)
        try:
            printer.format = OutputFormat(fmt)
        except ValueError:
            _fail(f"Unknown format: {fmt}")
        return True
    if arg == "-threshold":
        printer.log_odds_threshold = float(_need_arg(args, arg))
        return True
    if arg == "-nothreshold":
        printer.log_odds_threshold = float("-inf")
        args.popleft()
        return True
    if arg == "-savealign":
        state["align_file"] = _need_arg(args, arg)
        return True
    return False


def _parse_verbosity(args: deque, state) -> bool:
    from .logger import logger

    if args and args[0] == "-profile":
        # capture a JAX profiler trace of the whole run (device and
        # host; view with TensorBoard / xprof)
        state["profile_dir"] = _need_arg(args, "-profile")
        return True
    return logger.parse_args(args)


def _parse_unknown(args: deque, implicit: List[str], unlimited: bool) -> bool:
    """Bare filenames become implicit switches (optparser.cpp:32-54)."""
    if not args:
        return False
    arg = args[0]
    if arg == "-abort":
        # hidden stack-trace test flag (optparser.cpp:35-37)
        raise RuntimeError("abort triggered")
    if arg.startswith("-") or not implicit:
        _fail(f"Unknown option: {arg}")
    args.appendleft(implicit[0])
    if len(implicit) > 1 or not unlimited:
        implicit.pop(0)
    return True


def _peek_distributed_args(argv: List[str]) -> dict:
    """Pre-scan for -coordinator/-nprocs/-procid BEFORE the JAX backend
    initialises — the multi-host runtime must be wired first (the
    analogue of the reference's ssh-bootstrap-before-work,
    qmodel.cpp:1093-1125).

    QUAFF_COORDINATOR / QUAFF_NPROCS / QUAFF_PROCID mirror the flags
    (convenient under mpirun/SLURM wrappers).
    """
    import os

    out = {}
    vals = {"-coordinator": None, "-nprocs": None, "-procid": None}
    for i, a in enumerate(argv):
        if a in vals and i + 1 < len(argv):
            vals[a] = argv[i + 1]
    coord = vals["-coordinator"] or os.environ.get("QUAFF_COORDINATOR")
    nprocs = vals["-nprocs"] or os.environ.get("QUAFF_NPROCS")
    procid = vals["-procid"] or os.environ.get("QUAFF_PROCID")
    if coord:
        out["coordinator_address"] = coord
    if nprocs is not None:
        out["num_processes"] = int(nprocs)
    if procid is not None:
        out["process_id"] = int(procid)
    return out


def _setup_jax(dist_args: Optional[dict] = None):
    """Join the multi-host cluster if asked, decide x64, and place the
    compile cache.  JAX_PLATFORMS chooses the platform.

    x64 is on where the default backend is the CPU: golden parity needs
    f64 fills.  On a GPU it stays off: the device scorers run in float32,
    and with x64 on every array made without an explicit dtype (iotas,
    literals, the score tables) would be 64-bit on the card.  The f64
    parity fills and tracebacks run on the CPU device inside
    precision.x64_scope.  QUAFF_TPU_X64=0/1 overrides."""
    import os

    import jax

    if dist_args:
        # join the multi-host cluster before the first backend query
        from .parallel.distributed import init_distributed

        init_distributed(
            coordinator_address=dist_args.get("coordinator_address"),
            num_processes=dist_args.get("num_processes"),
            process_id=dist_args.get("process_id"),
        )
    want = os.environ.get("QUAFF_TPU_X64")
    if want is not None:
        jax.config.update("jax_enable_x64", want not in ("0", "false"))
    elif jax.default_backend() == "cpu":
        jax.config.update("jax_enable_x64", True)
    from .device import setup_compile_cache

    setup_compile_cache()


def _load_params(args_state, prior=None):
    from .model.params import QuaffParams, default_params

    fn = args_state.get("params_file")
    if fn:
        return QuaffParams.from_json(open(fn).read())
    if prior is not None:
        return prior.fit()
    return default_params()


def _load_or_fit_null(args_state, reads):
    from .model.params import QuaffNullParams

    fn = args_state.get("null_file")
    if fn:
        null = QuaffNullParams.from_json(open(fn).read())
    else:
        null = QuaffNullParams.fit(reads)
    sf = args_state.get("savenull_file")
    if sf:
        from .parallel.distributed import is_primary

        if is_primary():
            with open(sf, "w") as f:
                null.write_json(f)
    return null


def _parse_model_files(args: deque, state) -> bool:
    if not args:
        return False
    arg = args[0]
    if arg == "-params":
        state["params_file"] = _need_arg(args, arg)
        return True
    if arg == "-null":
        state["null_file"] = _need_arg(args, arg)
        return True
    if arg == "-savenull":
        state["savenull_file"] = _need_arg(args, arg)
        return True
    return False


def _server_args(
    mode: str,
    config,
    state,
    printer=None,
    force: bool = False,
    fwdstrand: bool = False,
    noquals: bool = False,
    ref_files: Optional[List[str]] = None,
    read_files: Optional[List[str]] = None,
    print_all: bool = False,
) -> str:
    """Serialise the client's config into worker CLI flags — the
    flags-as-wire-format scheme of setServerArgs (qmodel.cpp:993-1006).

    When rsync/S3 staging is active, file paths are rewritten to the
    worker-side staging directory (makeServerArgs, qmodel.cpp:1019-1028).
    """
    staging = config.use_rsync or bool(config.bucket)

    def fpath(fn: str) -> str:
        if staging:
            import os

            from .bootstrap import SYNC_STAGING_DIR

            return f"{SYNC_STAGING_DIR}/{os.path.basename(fn)}"
        return fn

    parts = [mode]
    if force:
        parts.append("-force")
    if print_all:
        parts.append("-printall")
    if printer is not None:
        parts.append(f"-format {printer.format.value}")
        if printer.log_odds_threshold > float("-inf"):
            parts.append(f"-threshold {printer.log_odds_threshold:g}")
        else:
            parts.append("-nothreshold")
    if fwdstrand:
        parts.append("-fwdstrand")
    if noquals:
        parts.append("-noquals")
    if config.sparse:
        parts.append(f"-kmatchband {config.band_size} -kmatch {config.kmer_len}")
        if config.kmer_threshold >= 0:
            parts.append(f"-kmatchn {config.kmer_threshold}")
        else:
            parts.append(f"-kmatchmb {config.max_size >> 20}")
    else:
        parts.append("-kmatchoff")
    if config.bucket:
        parts.append(f"-s3bucket {config.bucket}")
        if config.aws_path != "aws":
            parts.append(f"-awspath {config.aws_path}")
    if state.get("params_file"):
        parts.append(f"-params {fpath(state['params_file'])}")
    if state.get("null_file"):
        parts.append(f"-null {fpath(state['null_file'])}")
    for f in ref_files or []:
        parts.append(f"-ref {fpath(f)}")
    for f in read_files or []:
        parts.append(f"-read {fpath(f)}")
    from .logger import logger

    return " ".join(parts) + logger.args()


def _collect_file_args(config, state, refs_args=None, reads_args=None) -> None:
    """Record every file the workers must open, for rsync/S3 staging
    (addFileArg/addReadFileArg, qmodel.cpp:1008-1016)."""
    config.file_args = []
    for key, tag in (("params_file", "-params"), ("null_file", "-null")):
        if state.get(key):
            config.file_args.append((tag, state[key]))
    for sl, tag in ((refs_args, "-ref"), (reads_args, "-read")):
        if sl is not None:
            for fn in sl.filenames:
                config.file_args.append((tag, fn))


def _launch_remote_pool(config, sargs: str):
    """ssh/EC2 worker bootstrap before remote dispatch
    (startRemoteServers, qmodel.cpp:1093-1125).

    Returns (pool_handles, extra_remotes): pool_handles is None or a
    (RemoteServerPool, ElasticPool|None) tuple to stop after the run;
    extra_remotes is a list of (addr, port) worker endpoints.
    """
    if not (config.remote_jobs or config.ec2_instances > 0):
        return None, []
    from . import bootstrap as bs

    specs = [
        bs.RemoteServerSpec(addr=a, port=p, threads=t, user=u)
        for (u, a, p, t) in config.remote_jobs
    ]
    elastic = None
    if config.ec2_instances > 0:
        elastic = bs.ElasticPool(
            ami=config.ec2_ami or bs.AWS_DEFAULT_AMI,
            instance_type=config.ec2_type or bs.AWS_DEFAULT_INSTANCE_TYPE,
            user=config.ec2_user,
            key_pair=config.ec2_key,
            security_group=config.ec2_group,
            aws_path=config.aws_path,
        )
        addrs = elastic.launch(
            config.ec2_instances,
            f"mkdir -p -m a=rwx {bs.SYNC_STAGING_DIR}\n",
        )
        specs += [
            bs.RemoteServerSpec(
                addr=a,
                port=config.ec2_port,
                threads=config.ec2_cores,
                user=config.ec2_user,
                instance_id=iid,
            )
            for a, iid in zip(addrs, elastic.instance_ids)
        ]
    # file staging: S3 bucket overrides rsync (qmodel.cpp:1113)
    if config.bucket:
        for _tag, fn in config.file_args:
            bs.sync_to_bucket(config.bucket, fn, config.aws_path)
    elif config.use_rsync:
        for spec in specs:
            for _tag, fn in config.file_args:
                bs.sync_to_remote(fn, spec, config.rsync_path, config.ssh_path)
    pool = bs.RemoteServerPool(
        bs.SshLauncher(config.ssh_path, config.ssh_key),
        worker_command=config.worker_path or _default_worker_command(),
        elastic=elastic,
    )
    extra = pool.start(specs, sargs)
    return (pool, elastic), extra


def _stop_remote_pool(pool_handles) -> None:
    if pool_handles is None:
        return
    pool, elastic = pool_handles
    pool.stop()
    if elastic is not None:
        elastic.terminate_all()


def _default_worker_command() -> str:
    import os
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    # preserve the caller's PYTHONPATH (it may carry sitecustomize hooks
    # the accelerator runtime needs)
    extra = os.environ.get("PYTHONPATH")
    path = f"{root}:{extra}" if extra else str(root)
    return f"PYTHONPATH={path} {sys.executable} -m quaff_tpu.cli"


def _make_qsub_runner(config, server_args: str):
    from .batch import QsubConfig, QsubRunner

    worker = config.worker_path or _default_worker_command()
    return QsubRunner(
        QsubConfig(
            jobs=config.qsub_jobs,
            qsub_path=config.qsub_path,
            qsub_opts=config.qsub_opts,
            header=config.qsub_header,
            temp_dir=config.qsub_dir,
            worker_command=worker,
            server_args=server_args,
        )
    )


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = deque(argv)
    if not args:
        sys.stderr.write(f"Usage: {PROG} {{help,train,align,overlap,count}} [options]\n")
        return 1
    command = args.popleft()

    if command in ("help", "-help", "--help", "-h"):
        sys.stdout.write(USAGE)
        return 0
    if command in ("version", "-version", "--version", "-V"):
        sys.stdout.write(f"{PROG} {VERSION}\n")
        return 0

    _setup_jax(_peek_distributed_args(argv))
    from .aligner import DPConfig

    config = DPConfig()
    state: dict = {}

    dispatch = {
        "align": _cmd_align,
        "train": _cmd_train,
        "count": _cmd_count,
        "overlap": _cmd_overlap,
    }
    if command == "server":
        from .server import cmd_server

        dispatch["server"] = cmd_server
    handler = dispatch.get(command)
    if handler is None:
        sys.stderr.write(f"Unrecognized command: {command}\n")
        return 1

    # peek for -profile anywhere in the args (chain parsing will consume it)
    profile_dir = None
    if "-profile" in args:
        idx = list(args).index("-profile")
        if idx + 1 < len(args):
            profile_dir = list(args)[idx + 1]
    try:
        if profile_dir:
            import contextlib

            import jax

            with contextlib.ExitStack() as stack:
                stack.enter_context(jax.profiler.trace(profile_dir))
                return handler(args, config, state)
        return handler(args, config, state)
    except SystemExit:
        raise
    except (ValueError, OSError, RuntimeError) as e:
        # the reference exits with failure status on any error
        # (t/quaff.cpp:321-323)
        sys.stderr.write(f"{e}\n")
        return 1


def _out_stream(state):
    from .parallel.distributed import is_primary

    if not is_primary():
        # on a multi-host cluster only host 0 writes alignment output
        import os

        return open(os.devnull, "w")
    fn = state.get("align_file")
    return open(fn, "w") if fn else sys.stdout


def _cmd_align(args: deque, config, state) -> int:
    from .aligner import QuaffAligner
    from .formats.alignment import AlignmentPrinter

    printer = AlignmentPrinter()
    refs_args = SeqListArgs("-ref", want_quals=False, want_revcomps=True)
    reads_args = SeqListArgs("-read", want_quals=True, want_revcomps=False)
    config.kmer_threshold = DEFAULT_REFSEQ_KMER_THRESHOLD
    implicit = ["-ref", "-read"]
    print_all = False
    while args:
        if args[0] == "-printall":
            print_all = True
            args.popleft()
            continue
        if (
            _parse_verbosity(args, state)
            or _parse_printer(args, printer, state)
            or _parse_dp_config(args, config)
            or _parse_model_files(args, state)
            or refs_args.parse(args)
            or reads_args.parse(args)
            or reads_args.parse_noquals(args)
        ):
            continue
        if not _parse_unknown(args, implicit, True):
            break

    reads, _ = reads_args.load(check_duplicates=True)
    refs, _ = refs_args.load(check_duplicates=True)
    params = _load_params(state)
    null = _load_or_fit_null(state, reads)
    out = _out_stream(state)
    _collect_file_args(config, state, refs_args, reads_args)
    pool, extra_remotes = _launch_remote_pool(
        config,
        _server_args(
            "align",
            config,
            state,
            printer=printer,
            fwdstrand=not refs_args.want_revcomps,
            noquals=not reads_args.want_quals,
            ref_files=refs_args.filenames,
            read_files=reads_args.filenames,
            print_all=print_all,
        ),
    )
    if config.remotes or extra_remotes:
        from .server import RemoteWorker, remote_align_all

        workers = [
            RemoteWorker(a, p) for a, p in config.remotes + extra_remotes
        ]
        remote_align_all(out, workers, reads, refs, printer)
        for w in workers:
            w.close()
        _stop_remote_pool(pool)
    elif config.qsub_jobs > 0:
        from .batch import qsub_align_all

        sargs = _server_args(
            "align",
            config,
            state,
            printer=printer,
            fwdstrand=not refs_args.want_revcomps,
            noquals=not reads_args.want_quals,
            ref_files=refs_args.filenames,
            print_all=print_all,
        )
        qsub_align_all(out, _make_qsub_runner(config, sargs), reads, refs, printer)
    else:
        aligner = QuaffAligner(params, null, config, print_all=print_all)
        if config.use_mesh:
            # shard batch scoring over the device mesh (every workload is
            # parallelized, matching qmodel.cpp:2624-2646); host 0 owns
            # the output on a multi-host cluster (_out_stream)
            from .logger import logger
            from .parallel.distributed import make_global_mesh

            aligner.mesh = make_global_mesh(1)
            logger.log(
                1,
                f"Mesh alignment over {aligner.mesh.devices.size} devices",
            )
        aligner.align_all(out, refs, reads, printer)
    if out is not sys.stdout:
        out.close()
    return 0


def _cmd_count(args: deque, config, state) -> int:
    from .trainer import QuaffCounter

    refs_args = SeqListArgs("-ref", want_quals=False, want_revcomps=True)
    reads_args = SeqListArgs("-read", want_quals=True, want_revcomps=False)
    config.kmer_threshold = DEFAULT_REFSEQ_KMER_THRESHOLD
    implicit = ["-ref", "-read"]
    allow_null = True
    save_counts = None
    fast_counts = False
    while args:
        if args[0] == "-force":
            allow_null = False
            args.popleft()
            continue
        if args[0] == "-fast":
            fast_counts = True
            args.popleft()
            continue
        if args[0] == "-savecounts":
            save_counts = _need_arg(args, args[0])
            continue
        if (
            _parse_verbosity(args, state)
            or _parse_dp_config(args, config)
            or _parse_model_files(args, state)
            or refs_args.parse(args)
            or reads_args.parse(args)
        ):
            continue
        if not _parse_unknown(args, implicit, True):
            break

    reads, _ = reads_args.load()
    refs, _ = refs_args.load()
    params = _load_params(state)
    null = _load_or_fit_null(state, reads)
    _collect_file_args(config, state, refs_args, reads_args)
    pool, extra_remotes = _launch_remote_pool(
        config,
        _server_args(
            "count",
            config,
            state,
            force=not allow_null,
            fwdstrand=not refs_args.want_revcomps,
            ref_files=refs_args.filenames,
            read_files=reads_args.filenames,
        ),
    )
    if config.remotes or extra_remotes:
        from .server import RemoteWorker, remote_get_counts

        workers = [
            RemoteWorker(a, p) for a, p in config.remotes + extra_remotes
        ]
        counts, loglike, _ = remote_get_counts(workers, refs, reads, params, null)
        for w in workers:
            w.close()
        _stop_remote_pool(pool)
    elif config.qsub_jobs > 0:
        from .batch import qsub_get_counts

        sargs = _server_args(
            "count",
            config,
            state,
            force=not allow_null,
            fwdstrand=not refs_args.want_revcomps,
            ref_files=refs_args.filenames,
        )
        counts, loglike, _ = qsub_get_counts(
            _make_qsub_runner(config, sargs), refs, reads, params, null
        )
    elif fast_counts:
        # `count -fast`: the production-precision E-step train itself
        # runs (f32, on the GPU where there is one); `-mesh` shards it
        # over the device mesh exactly like
        # `train -mesh`.  Totals differ from the f64 parity artifact
        # only by f32 accumulation rounding (documented tolerance in
        # docs/manual.md; pinned by tests/test_count_fast.py).
        import jax

        if config.use_mesh:
            import jax.numpy as jnp

            from .parallel.distributed import make_global_mesh
            from .parallel.estep import MeshCountsProvider

            n_dev = len(jax.devices())
            if config.mesh_mp > n_dev or n_dev % config.mesh_mp != 0:
                raise SystemExit(
                    f"-meshmp {config.mesh_mp} must divide the device "
                    f"count ({n_dev} available)"
                )
            mesh = make_global_mesh(config.mesh_mp)
            provider = MeshCountsProvider(
                mesh, refs, reads, params, null, config,
                allow_null=allow_null, dtype=jnp.float32,
            )
            counts, loglike, _ = provider(
                params, [list(range(len(refs))) for _ in reads]
            )
        else:
            import jax.numpy as jnp

            config.dtype = jnp.float32  # production precision, always
            counter = QuaffCounter(
                params, null, config, use_null_model=allow_null,
            )
            counts, loglike, _ = counter.get_counts(refs, reads)
    else:
        # the `count` command's JSON output is a parity artifact: compute
        # the exact f64 path on the CPU device even on accelerator backends
        import jax

        if config.use_mesh:
            from .logger import logger

            logger.log(
                1,
                "count: -mesh ignored without -fast (count output is the "
                "f64 parity artifact; mesh-sharded counts need `-fast`)",
            )
        from .precision import x64_scope

        with x64_scope(), jax.default_device(jax.devices("cpu")[0]):
            counter = QuaffCounter(
                params, null, config, use_null_model=allow_null,
                prefer_device=False,
            )
            counts, loglike, _ = counter.get_counts(refs, reads)
    from .parallel.distributed import is_primary

    if not is_primary():
        return 0  # host 0 owns the counts artifact on multi-host runs
    if save_counts:
        with open(save_counts, "w") as f:
            counts.write_json(f)
            f.write("\n")
    else:
        counts.write_json(sys.stdout)
    return 0


def _cmd_train(args: deque, config, state) -> int:
    from .model.params import QuaffParamCounts, QuaffParams
    from .trainer import QuaffTrainer

    refs_args = SeqListArgs("-ref", want_quals=False, want_revcomps=True)
    reads_args = SeqListArgs("-read", want_quals=True, want_revcomps=False)
    config.kmer_threshold = DEFAULT_REFSEQ_KMER_THRESHOLD
    implicit = ["-ref", "-read"]
    trainer = QuaffTrainer()
    match_order, gap_order = 1, 0
    order_specified = False
    prior_file = None
    save_prior = None
    while args:
        arg = args[0]
        if arg == "-maxiter":
            trainer.max_iterations = int(_need_arg(args, arg))
            continue
        if arg == "-mininc":
            trainer.min_fractional_loglike_increment = float(_need_arg(args, arg))
            continue
        if arg == "-maxreadmb":
            trainer.max_read_bases = int(0.5 + 1e6 * float(_need_arg(args, arg)))
            continue
        if arg == "-force":
            trainer.allow_null_model = False
            args.popleft()
            continue
        if arg == "-saveparams":
            trainer.save_params_filename = _need_arg(args, arg)
            continue
        if arg == "-savecounts":
            trainer.raw_counts_filename = _need_arg(args, arg)
            continue
        if arg == "-savecountswithprior":
            trainer.counts_with_prior_filename = _need_arg(args, arg)
            continue
        if arg == "-checkpoint":
            trainer.checkpoint_dir = _need_arg(args, arg)
            continue
        if arg == "-order":
            k = int(_need_arg(args, arg))
            match_order, gap_order = 1 + k, k
            order_specified = True
            continue
        if arg == "-suborder":
            match_order = 1 + int(_need_arg(args, arg))
            order_specified = True
            continue
        if arg == "-gaporder":
            gap_order = int(_need_arg(args, arg))
            order_specified = True
            continue
        if arg == "-prior":
            prior_file = _need_arg(args, arg)
            continue
        if arg == "-saveprior":
            save_prior = _need_arg(args, arg)
            continue
        if (
            _parse_verbosity(args, state)
            or _parse_dp_config(args, config)
            or _parse_model_files(args, state)
            or refs_args.parse(args)
            or reads_args.parse(args)
        ):
            continue
        if not _parse_unknown(args, implicit, True):
            break

    reads, _ = reads_args.load()
    refs, _ = refs_args.load()
    null = _load_or_fit_null(state, reads)

    params_file = state.get("params_file")
    if prior_file:
        prior = QuaffParamCounts.from_json(open(prior_file).read())
    else:
        # auto-set prior from null model (requirePriorOrUseNullModel,
        # t/quaff.cpp:490-515: initCounts(9, 9, 5, 1, &null))
        if params_file and not order_specified:
            seed_probe = QuaffParams.from_json(open(params_file).read())
            match_order = seed_probe.match_kmer_len
            gap_order = seed_probe.indel_kmer_len
        prior = QuaffParamCounts.zero(match_order, gap_order)
        prior.init_counts(9, 9, 5, 1, null)
    if save_prior:
        from .parallel.distributed import is_primary

        if is_primary():
            with open(save_prior, "w") as f:
                prior.write_json(f)
                f.write("\n")

    from .logger import logger

    params = _load_params(state, prior=prior)

    # remote/qsub E-step dispatch (QuaffTrainer::getCounts wraps each EM
    # iteration's counting in startRemoteServers/stopRemoteServers,
    # qmodel.cpp:2034-2041)
    _collect_file_args(config, state, refs_args, reads_args)
    sargs = _server_args(
        "count",
        config,
        state,
        force=not trainer.allow_null_model,
        fwdstrand=not refs_args.want_revcomps,
        ref_files=refs_args.filenames,
        read_files=reads_args.filenames,
    )
    import jax

    if jax.process_count() > 1 and not config.use_mesh:
        raise SystemExit(
            "multi-host runs (-nprocs > 1) require -mesh: the global "
            "device mesh is the multi-host execution path"
        )
    pool, extra_remotes = _launch_remote_pool(config, sargs)
    counts_provider = None
    workers = []
    all_remotes = config.remotes + extra_remotes
    if all_remotes:
        from .server import RemoteWorker, remote_get_counts

        workers = [RemoteWorker(a, p) for a, p in all_remotes]

        def counts_provider(qp, order):
            return remote_get_counts(workers, refs, reads, qp, null, order)

    elif config.qsub_jobs > 0:
        from .batch import qsub_get_counts

        qsub_sargs = _server_args(
            "count",
            config,
            state,
            force=not trainer.allow_null_model,
            fwdstrand=not refs_args.want_revcomps,
            ref_files=refs_args.filenames,
        )
        runner = _make_qsub_runner(config, qsub_sargs)

        def counts_provider(qp, order):
            return qsub_get_counts(runner, refs, reads, qp, null, order)

    elif config.use_mesh:
        # device-mesh data parallelism: shard the E-step pair grid over
        # all attached devices — across every host of a multi-host
        # cluster when -coordinator/-nprocs joined one (the scale-out
        # axis; see parallel/estep.MeshCountsProvider)
        import jax
        import jax.numpy as jnp

        from .parallel.distributed import make_global_mesh
        from .parallel.estep import MeshCountsProvider

        n_dev = len(jax.devices())
        if config.mesh_mp > n_dev or n_dev % config.mesh_mp != 0:
            raise SystemExit(
                f"-meshmp {config.mesh_mp} must divide the device count "
                f"({n_dev} available)"
            )
        mesh = make_global_mesh(config.mesh_mp)
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        counts_provider = MeshCountsProvider(
            mesh, refs, trainer.effective_reads(reads), params, null, config,
            allow_null=trainer.allow_null_model, dtype=dtype,
        )
        logger.log(
            1,
            f"Mesh E-step over {mesh.devices.size} devices "
            f"(dp={mesh.shape['dp']}, mp={mesh.shape['mp']})",
        )

    new_params = trainer.fit(
        refs,
        reads,
        params,
        null,
        prior,
        config,
        log=lambda msg: logger.log(1, msg),
        counts_provider=counts_provider,
    )
    for w in workers:
        w.close()
    _stop_remote_pool(pool)
    if not trainer.save_params_filename:
        from .parallel.distributed import is_primary

        if is_primary():
            new_params.write_json(sys.stdout)
    return 0


def _cmd_overlap(args: deque, config, state) -> int:
    from .formats.alignment import AlignmentPrinter
    from .overlap import QuaffOverlapAligner

    printer = AlignmentPrinter()
    reads_args = SeqListArgs("-read", want_quals=True, want_revcomps=True)
    implicit = ["-read"]
    while args:
        if (
            _parse_verbosity(args, state)
            or _parse_printer(args, printer, state)
            or _parse_dp_config(args, config, general_only=True)
            or _parse_model_files(args, state)
            or reads_args.parse(args)
            or reads_args.parse_noquals(args)
        ):
            continue
        if not _parse_unknown(args, implicit, True):
            break

    seqs, n_originals = reads_args.load(check_duplicates=True)
    params = _load_params(state)
    null = _load_or_fit_null(state, seqs)
    out = _out_stream(state)
    _collect_file_args(config, state, reads_args=reads_args)
    pool, extra_remotes = _launch_remote_pool(
        config,
        _server_args(
            "overlap",
            config,
            state,
            printer=printer,
            fwdstrand=not reads_args.want_revcomps,
            noquals=not reads_args.want_quals,
            read_files=reads_args.filenames,
        ),
    )
    if config.remotes or extra_remotes:
        from .server import RemoteWorker, remote_overlap_all

        workers = [
            RemoteWorker(a, p) for a, p in config.remotes + extra_remotes
        ]
        aligner = QuaffOverlapAligner.__new__(QuaffOverlapAligner)
        remote_overlap_all(
            out, workers, seqs, n_originals, printer, aligner.enumerate_pairs
        )
        for w in workers:
            w.close()
        _stop_remote_pool(pool)
    elif config.qsub_jobs > 0:
        from .batch import qsub_overlap_all

        sargs = _server_args(
            "overlap",
            config,
            state,
            printer=printer,
            fwdstrand=not reads_args.want_revcomps,
            noquals=not reads_args.want_quals,
        )
        aligner = QuaffOverlapAligner.__new__(QuaffOverlapAligner)
        qsub_overlap_all(
            out,
            _make_qsub_runner(config, sargs),
            seqs,
            n_originals,
            printer,
            aligner.enumerate_pairs,
        )
    else:
        aligner = QuaffOverlapAligner(params, null, config)
        if config.use_mesh:
            # shard pair scoring over the device mesh (every workload is
            # parallelized, matching qoverlap.cpp:312-334); host 0 owns
            # the output on a multi-host cluster (_out_stream)
            from .logger import logger
            from .parallel.distributed import make_global_mesh

            aligner.mesh = make_global_mesh(1)
            logger.log(
                1,
                f"Mesh overlap over {aligner.mesh.devices.size} devices",
            )
        aligner.align_all(out, seqs, n_originals, printer)
    if out is not sys.stdout:
        out.close()
    return 0


USAGE = f"""Usage: {PROG} {{help,train,align,overlap}} [options]

Commands:

TRAINING

 {PROG} train refs.fasta reads.fastq  >params.json
  (to fit a model to unaligned sequences, using EM/Forward-Backward)

   -maxiter <n>    Max number of EM iterations (default is 100)
   -mininc <n>     EM convergence threshold as relative log-likelihood increase
   -maxreadmb <n>  Use only the first n megabases of the read training set
   -force          Force each read to match a refseq, i.e. disallow null model
   -suborder <k>   Allow substitutions to depend on k-mer contexts
   -gaporder <k>   Allow gap open probabilities to depend on k-mer contexts
   -order <k>      Shorthand for '-suborder <k> -gaporder <k>'
   -prior <file>, -saveprior <file>   Load/save prior pseudocounts
   -saveparams <file>, -savecounts <file>, -savecountswithprior <file>

ALIGNMENT

 {PROG} align refs.fasta reads.fastq
  (to align FASTQ reads to FASTA reference sequences, using Viterbi)

   -printall       Print all pairwise alignments, not just best for each read

 {PROG} overlap reads.fastq
  (to find overlaps between FASTQ reads, using Viterbi)

Alignment options:
   -threshold <n>, -nothreshold    Log-odds score threshold
   -noquals        Ignore read quality scores during alignment
   -savealign <file>               Stream alignments to file
   -format {{fasta,stockholm,sam,refseq}}

GENERAL

   -params <file>  Load model parameters from file
   -ref <file>     Load additional FASTA reference sequences
   -read <file>    Load additional FASTQ read sequences
   -fwdstrand      Do not include reverse-complemented sequences
   -global         Force all of refseq to be aligned (align/train only)
   -null <file>, -savenull <file>  Load/save null model
   -kmatch <k>     Length of kmers for pre-filtering heuristic (default 6)
   -kmatchn <n>    Threshold# of kmer matches to seed a diagonal
   -kmatchband <n> Size of DP band around kmer-matching diagonals (default 64)
   -kmatchmb <M>   Set kmer threshold to use M megabytes of memory
   -kmatchmax      Set kmer threshold to use all available memory (slow)
   -kmatchoff      No kmer threshold, do full DP

PARALLEL PROCESSING

On several GPUs, scaling is via the device mesh (data/model/sequence
parallel shardings; see docs/manual.md):
   -mesh           Shard the training E-step over all attached devices
   -meshmp <K>     Also shard references over a model-parallel axis of K
Multi-host clusters (every host runs the same command; -mesh then spans
the global device set; host 0 writes the output):
   -coordinator <host:port>   Cluster coordinator (host 0's address)
   -nprocs <N>     Number of processes (hosts) in the cluster
   -procid <I>     This process's id, 0..N-1
   (or env QUAFF_COORDINATOR/QUAFF_NPROCS/QUAFF_PROCID)
The reference's cluster backends are also supported:

Sockets:
   -threads <N>, -maxthreads       Worker thread/port count
   -remote [user@]host[:port[-maxport]]
                   With user@: ssh-launch a remote worker server.
                   Bare host:port: connect to an already-running server.
   -sshkey <file>  SSH private key file
   -sshpath <p>, -rsyncpath <p>, -awspath <p>    Paths to ssh / rsync / aws
   -remotepath <p> Path to remote worker command
   -rsync          Client rsyncs data files to the worker staging dir
   -s3bucket <B>   Client/worker sync data files via S3 bucket B
   -ec2instances <N>               Launch N temporary EC2 instances
   -ec2ami <AMI>, -ec2type <type>, -ec2cores <n>, -ec2user <user>,
   -ec2key <keypair>, -ec2group <group>, -ec2port <port>

Queueing system (requires NFS):
   -qsubjobs <N>   Submit up to N simultaneous jobs
   -qsub <path>, -qsubopts <options>   Submission program and options
   -qsubdir <path> Temp directory for job scripts (must be on NFS)
   -qsubheader <f> Header for job scripts (e.g. PBS directives)

LOGGING

   -verbose, -v1..-v9   Verbosity level
   -log <tag>      Targeted dumps (dpmatrix, postmatrix)
   -nocolor        Plain log output
   -profile <dir>  Capture a JAX profiler trace of the run
"""


if __name__ == "__main__":
    sys.exit(main())
