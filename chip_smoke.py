"""Smoke test of quaff on an NVIDIA GPU: the main paths, once each,
through the entry points a user calls, at the c8f30 model's full width
(the default nanopore pair HMM; 6,604-base reads; banded width 256 after
strip packing).  Reads are made from tests/data/c8f30.fastq.gz with a
fixed seed.

    python chip_smoke.py             # one GPU: every phase below
    python chip_smoke.py --cards 4   # four GPUs: the mesh E-step only

Phases (one line each; any failure exits non-zero):
  device   a GPU is JAX's default device; its name and power limit
  native   the host runtime (libquaffio) builds and loads
  scorers  each device scorer compiled at c8f30 width, its memory
           analysis, and its largest error against the f64 reference
  align    CLI align of 256 reads, byte-identical to the host f64 route
  train    CLI train (2 EM iterations, 128 reads); count -fast on the
           synth12 data within the documented tolerance
  overlap  CLI overlap of 64 reads, byte-identical to the host route
  server   a loopback `server align` answering 3 requests

The last line is one JSON object naming the device.
"""

import argparse
import contextlib
import io
import json
import pathlib
import socket
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"
WORK = ROOT / ".chip_smoke"

ALIGN_TOL = 0.1  # nats: well inside the 1.0-nat winner-refill margin
OVERLAP_TOL = 0.1  # nats: well inside the exact pass's 0.25-nat strip cut


def say(phase, **fields):
    print(phase, json.dumps(fields, default=str), flush=True)


def phase_device():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX's default platform is {devs[0].platform!r})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    say("device", kind=devs[0].device_kind, count=len(devs))
    return devs


def phase_native():
    from quaff_tpu import native

    native.get_lib(auto_build=True)
    if not native.available():
        raise RuntimeError("libquaffio did not build or load (make -C native)")
    say("native", loaded=True)


def c8f30_reads(n, seed, sub_rate=0.02):
    """n mutated copies of c8f30 (substitutions at sub_rate, the read's
    own qualities)."""
    import numpy as np

    from quaff_tpu.io.fastseq import FastSeq, read_fast_seqs

    base = read_fast_seqs(str(DATA / "c8f30.fastq.gz"))[0]
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        s = np.array(list(base.seq))
        m = rng.random(len(s)) < sub_rate
        s[m] = rng.choice(list("ACGT"), int(m.sum()))
        out.append(FastSeq(name=f"c8f30_{seed}_{i}", seq="".join(s), qual=base.qual))
    return out


def overlap_reads(n, seed):
    """n substrings of c8f30 (1/3 to 1/2 of its length, 5% substitutions)."""
    import numpy as np

    from quaff_tpu.io.fastseq import FastSeq, read_fast_seqs

    base = read_fast_seqs(str(DATA / "c8f30.fastq.gz"))[0]
    rng = np.random.default_rng(seed)
    L = len(base.seq)
    out = []
    for i in range(n):
        s0 = int(rng.integers(0, L // 2))
        ln = int(rng.integers(L // 3, L // 2))
        seq = list(base.seq[s0 : s0 + ln])
        for _ in range(int(len(seq) * 0.05)):
            seq[int(rng.integers(0, len(seq)))] = "ACGT"[int(rng.integers(0, 4))]
        out.append(FastSeq(name=f"ov{i}", seq="".join(seq), qual=base.qual[s0 : s0 + ln]))
    return out


def write_fastq(path, reads):
    with open(path, "w") as fh:
        for r in reads:
            r.write_fastq(fh)
    return str(path)


def cli(argv):
    from quaff_tpu.cli import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(list(argv))
    if rc != 0:
        raise RuntimeError(f"quaff {' '.join(argv)} exited {rc}")
    return out.getvalue()


@contextlib.contextmanager
def host_route():
    """The CPU route (host-native f64 scoring) in this GPU process; fails
    if a device scorer runs inside it."""
    import quaff_tpu.device as device

    saved = device.device_scorers
    before = dict(device.DISPATCHES)
    device.device_scorers = lambda: False
    try:
        yield
    finally:
        device.device_scorers = saved
    if dict(device.DISPATCHES) != before:
        raise RuntimeError("host route: a device scorer ran")


def phase_scorers():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from quaff_tpu import native
    from quaff_tpu.aligner import DPConfig, FWDBACK_CELL_SIZE, VITERBI_CELL_SIZE
    from quaff_tpu.dp import align_kernel
    from quaff_tpu.dp.counts import dp_forward_backward
    from quaff_tpu.dp.engine import PairBatch, device_batch, device_tables
    from quaff_tpu.dp.overlap import OverlapScoreTables, overlap_device_tables, overlap_fill
    from quaff_tpu.dp.scores import ScoreTables
    from quaff_tpu.envelope import pack_strips
    from quaff_tpu.io.fastseq import KmerIndex, read_fast_seqs
    from quaff_tpu.model.params import default_params
    from quaff_tpu.overlap import OverlapBatch
    from quaff_tpu.precision import x64_scope

    params = default_params()
    tables = ScoreTables.from_params(params)
    tdev = device_tables(tables)
    cfg = DPConfig()
    x = read_fast_seqs(str(DATA / "c8f30.fastq.gz"))[0]
    x.qual = ""
    reads = c8f30_reads(256, seed=1)

    # align kernel: 256 lane-packed pairs, 6,604 rows, W=256 block
    pairs = [
        (x, y, cfg.make_envelope(x, KmerIndex(y, cfg.kmer_len), VITERBI_CELL_SIZE))
        for y in reads
    ]
    packed = PairBatch.build_packed(pairs, tables, width=256)
    reach = align_kernel.scan_reach(packed.seg_width)
    bdev = device_batch(packed)
    fn = jax.jit(lambda t, b: align_kernel.viterbi_scores(t, b, reach=reach))
    compiled = fn.lower(tdev, bdev).compile()
    t0 = time.perf_counter()
    got = np.asarray(jax.block_until_ready(compiled(tdev, bdev)), np.float64)
    dt = time.perf_counter() - t0
    ref = native.align_score_native(PairBatch.build(pairs, tables), tables)
    err = float(np.max(np.abs(got - ref)))
    say("scorer align_kernel", pairs=len(pairs), width=packed.member.shape[1],
        rows=packed.max_y_len, seconds=dt, max_err_nat=err, tol_nat=ALIGN_TOL,
        memory=compiled.memory_analysis())
    if not err <= ALIGN_TOL:
        raise RuntimeError(f"align kernel error {err} > {ALIGN_TOL}")

    # E-step: forward-backward with counts, f32 on the device; compiled
    # at 256 pairs for its memory analysis, compared on 2 pairs with the
    # f64 host fill
    fb_pairs = [
        (x, y, cfg.make_envelope(x, KmerIndex(y, cfg.kmer_len), FWDBACK_CELL_SIZE))
        for y in reads
    ]
    width = max(e.band_width for _, _, e in fb_pairs)
    kw = dict(local=True, dtype=jnp.float32, num_match_kmers=params.num_match_kmers,
              num_indel_kmers=params.num_indel_kmers)
    big = device_batch(PairBatch.build(fb_pairs, tables, width=width))
    mem = dp_forward_backward.lower(tdev, big, **kw).compile().memory_analysis()
    del big
    small = PairBatch.build(fb_pairs[:2], tables, width=width)
    res = jax.block_until_ready(dp_forward_backward(tdev, device_batch(small), **kw))
    cpu = jax.devices("cpu")[0]
    with x64_scope(), jax.default_device(cpu):
        t64 = device_tables(tables)
        b64 = {k: jax.device_put(v, cpu) for k, v in device_batch(small).items()}
        want = dp_forward_backward(t64, b64, **dict(kw, dtype=jnp.float64))
        want = {k: np.asarray(v) for k, v in want.items()}
    worst = 0.0  # largest |error| / tolerance over every count
    for k in ("match_counts", "insert_counts", "m2m", "m2i", "m2d", "m2e",
              "i2i", "i2m", "d2d", "d2m"):
        g, w = np.asarray(res[k], np.float64), want[k]
        ratio = np.abs(g - w) / (5e-3 + 5e-3 * np.abs(w))
        worst = max(worst, float(np.max(ratio)))
    fwd_err = float(np.max(np.abs(np.asarray(res["fwd_score"], np.float64) - want["fwd_score"])))
    say("scorer estep", compiled_pairs=len(fb_pairs), width=width,
        rows=small.max_y_len, fwd_err_nat=fwd_err,
        worst_count_err_over_tol=worst, memory=mem)
    if worst > 1:
        raise RuntimeError("E-step counts outside 5e-3 + 5e-3*|count|")

    # overlap scorer: 256 envelope strips of c8f30 substrings against
    # each other, f32 score-only, against the native f64 fill
    ov = overlap_reads(24, seed=2)
    ot = OverlapScoreTables.from_params(params, y_complemented=False)
    strips = []
    for i, a in enumerate(ov):
        for b in ov[i + 1 :]:
            env = cfg.make_envelope(a, KmerIndex(b, cfg.kmer_len), VITERBI_CELL_SIZE)
            strips.extend((a, b, s) for s in pack_strips(env))
    strips = strips[:256]
    ob = OverlapBatch(strips, ot, width=256)
    odev = ob.device()
    otab = overlap_device_tables(ot)
    ofn = jax.jit(lambda t, b: overlap_fill(t, b, dtype=jnp.float32)["score"])
    ocomp = ofn.lower(otab, odev).compile()
    t0 = time.perf_counter()
    og = np.asarray(jax.block_until_ready(ocomp(otab, odev)), np.float64)
    odt = time.perf_counter() - t0
    oref = np.asarray(native.overlap_score_native(ob, ot), np.float64)
    fin = np.isfinite(oref)
    if not np.array_equal(fin, np.isfinite(og)):
        raise RuntimeError("overlap scorer: finite pattern differs from f64")
    oerr = float(np.max(np.abs(og[fin] - oref[fin]))) if fin.any() else 0.0
    say("scorer overlap", strips=len(strips), width=ob.base.member.shape[1],
        rows=ob.base.max_y_len, seconds=odt, max_err_nat=oerr, tol_nat=OVERLAP_TOL,
        memory=ocomp.memory_analysis())
    if not oerr <= OVERLAP_TOL:
        raise RuntimeError(f"overlap scorer error {oerr} > {OVERLAP_TOL}")


def phase_align():
    from quaff_tpu.device import DISPATCHES

    reads = write_fastq(WORK / "align256.fastq", c8f30_reads(256, seed=3))
    argv = ["align", str(DATA / "c8f30.fastq.gz"), reads]
    before = DISPATCHES["align"]
    t0 = time.perf_counter()
    dev = cli(argv)
    dt = time.perf_counter() - t0
    n = DISPATCHES["align"] - before
    with host_route():
        t0 = time.perf_counter()
        host = cli(argv)
        dt_host = time.perf_counter() - t0
    say("align", reads=256, seconds=dt, host_seconds=dt_host, dispatches=n,
        identical=dev == host, alignments=dev.count("#=GS"))
    if n <= 0 or dev != host or "Score" not in dev:
        raise RuntimeError("align: no device dispatch, or output differs from the host route")


def phase_train():
    from quaff_tpu.device import DISPATCHES

    reads = write_fastq(WORK / "train128.fastq", c8f30_reads(128, seed=4))
    before = DISPATCHES["estep"]
    t0 = time.perf_counter()
    out = cli(["train", str(DATA / "c8f30.fastq.gz"), reads, "-maxiter", "2"])
    dt = time.perf_counter() - t0
    n = DISPATCHES["estep"] - before
    fitted = json.loads(out)
    if n <= 0 or "match" not in fitted:
        raise RuntimeError("train: no device dispatch, or no fitted params")

    base = ["count", str(DATA / "synth12-genome.fasta"), str(DATA / "synth12.fastq"),
            "-kmatchn", "10", "-fwdstrand"]
    before = DISPATCHES["estep"]
    fast = json.loads(cli(base + ["-fast"]))
    nf = DISPATCHES["estep"] - before
    parity = json.loads(cli(base))
    worst = []

    def walk(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for p, q in zip(a, b):
                walk(p, q)
        elif isinstance(a, (int, float)):
            worst.append(abs(a - b) / (5e-3 + 5e-3 * abs(b)))

    walk(fast, parity)
    say("train", reads=128, em_iterations=2, seconds=dt, dispatches=n,
        count_fast_dispatches=nf, count_fast_worst_err_over_tol=max(worst))
    if nf <= 0 or max(worst) > 1:
        raise RuntimeError("count -fast: no device dispatch, or outside tolerance")


def phase_overlap():
    from quaff_tpu.device import DISPATCHES

    reads = write_fastq(WORK / "overlap64.fastq", overlap_reads(64, seed=5))
    argv = ["overlap", reads]
    before = DISPATCHES["overlap"]
    t0 = time.perf_counter()
    dev = cli(argv)
    dt = time.perf_counter() - t0
    n = DISPATCHES["overlap"] - before
    with host_route():
        t0 = time.perf_counter()
        host = cli(argv)
        dt_host = time.perf_counter() - t0
    say("overlap", reads=64, seconds=dt, host_seconds=dt_host, dispatches=n,
        identical=dev == host, alignments=dev.count("#=GS") // 2)
    if n <= 0 or dev != host:
        raise RuntimeError("overlap: no device dispatch, or output differs from the host route")


def phase_server():
    from quaff_tpu.cli import main
    from quaff_tpu.server import RemoteWorker

    reads = c8f30_reads(3, seed=6)
    path = write_fastq(WORK / "server3.fastq", reads)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    th = threading.Thread(
        target=main,
        args=(["server", "align", str(DATA / "c8f30.fastq.gz"), path, "-port", str(port)],),
        daemon=True,
    )
    th.start()
    for _ in range(600):
        try:
            socket.create_connection(("localhost", port), timeout=0.2).close()
            break
        except OSError:
            time.sleep(0.1)
    worker = RemoteWorker("localhost", port)
    times = []
    for r in reads:
        t0 = time.perf_counter()
        reply = worker.request(json.dumps({"yName": r.name}))
        times.append(time.perf_counter() - t0)
        if "Score" not in reply:
            raise RuntimeError(f"server: reply for {r.name} has no Score")
    worker.quit()
    th.join(timeout=30)
    say("server", requests=len(reads), seconds=times)


def phase_cards(n_cards):
    """count -fast -mesh over n_cards GPUs against the same on one card."""
    import jax

    from quaff_tpu.device import DISPATCHES

    reads = write_fastq(WORK / "mesh64.fastq", c8f30_reads(64, seed=7))
    base = ["count", str(DATA / "c8f30.fastq.gz"), reads, "-fwdstrand", "-fast"]
    t0 = time.perf_counter()
    mesh = json.loads(cli(base + ["-mesh"]))
    dt_mesh = time.perf_counter() - t0
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0) for d in jax.devices()]
    before = DISPATCHES["estep"]
    t0 = time.perf_counter()
    one = json.loads(cli(base))
    dt_one = time.perf_counter() - t0
    worst = []

    def walk(a, b):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, list):
            for p, q in zip(a, b):
                walk(p, q)
        elif isinstance(a, (int, float)):
            worst.append(abs(a - b) / (5e-3 + 5e-3 * abs(b)))

    walk(mesh, one)
    say("cards", cards=n_cards, mesh_seconds=dt_mesh, one_card_seconds=dt_one,
        one_card_dispatches=DISPATCHES["estep"] - before,
        peak_bytes_in_use=peaks, worst_err_over_tol=max(worst))
    if len(jax.devices()) != n_cards or min(peaks) <= 0 or max(worst) > 1:
        raise RuntimeError("mesh E-step: a card sat idle or counts differ")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="run only the mesh E-step over this many GPUs")
    args = ap.parse_args()
    devs = phase_device()
    WORK.mkdir(exist_ok=True)
    if args.cards > 1:
        if len(devs) < args.cards:
            sys.exit(f"chip_smoke: {args.cards} GPUs asked for, {len(devs)} found")
        phase_cards(args.cards)
    else:
        phase_native()
        phase_scorers()
        phase_align()
        phase_train()
        phase_overlap()
        phase_server()
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs)}}))


if __name__ == "__main__":
    main()
