"""One-off GPU measurements behind PERF.md: the align kernel against the
XLA scan engine (alone and end to end), the XLA E-step and overlap
scorers through their pipelines, and `train -mesh` over every attached
GPU against the same run on one.

    python tools/gpu_measure.py [alone] [e2e] [estep] [overlap]
    python tools/gpu_measure.py train-mesh      # on a host with 2+ GPUs

Run from the repository root.  Each measurement prints one JSON line
(with the card's nvidia-smi name and power limit) to stdout; with
`--out FILE` the lines are appended to FILE as well.  Workloads are
chip_smoke.py's: mutated c8f30 copies and c8f30 substrings, from fixed
seeds.  Timings end in block_until_ready or in a finished CLI run.
"""

import argparse
import json
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from quaff_tpu.aligner import DPConfig, QuaffAligner, VITERBI_CELL_SIZE  # noqa: E402
from quaff_tpu.dp import align_kernel  # noqa: E402
from quaff_tpu.dp.engine import (  # noqa: E402
    PairBatch,
    device_batch,
    device_tables,
    dp_fill,
    pow2ceil,
)
from quaff_tpu.dp.scores import ScoreTables  # noqa: E402
from quaff_tpu.envelope import pack_strips  # noqa: E402
from quaff_tpu.io.fastseq import KmerIndex, read_fast_seqs  # noqa: E402
from quaff_tpu.model.params import default_params  # noqa: E402

C8F30 = str(cs.DATA / "c8f30.fastq.gz")
_out = None
_card = ""


def record(**fields):
    fields["card"] = _card
    line = json.dumps(fields)
    print(line, flush=True)
    if _out is not None:
        _out.write(line + "\n")
        _out.flush()


def round128(v):
    return -(-v // 128) * 128


def _strip_batch(pairs, tables, max_y_len=None):
    """The pairs' envelope strips, one batch row each (padded to a power
    of two), as the XLA scan engine scores them."""
    strips, owner, k_of = [], [], []
    for n, (x, y, env) in enumerate(pairs):
        for k, s in enumerate(pack_strips(env, 3)):
            strips.append((x, y, s))
            owner.append(n)
            k_of.append(k)
    strips += [strips[-1]] * (pow2ceil(len(strips)) - len(strips))
    width = round128(max(s.band_width for _, _, s in strips))
    batch = PairBatch.build(strips, tables, width=width, max_y_len=max_y_len)
    return batch, owner, k_of


def xla_score_chunk(self, pairs, width=None, max_y_len=None):
    """QuaffAligner._score_chunk through XLA's dp_fill over strips: the
    align route the kernel replaced, kept here to measure against."""
    batch, owner, k_of = _strip_batch(pairs, self.tables, max_y_len)
    s = np.asarray(
        dp_fill(self._tdev, device_batch(batch), mode="viterbi",
                local=self.config.local, return_matrices=False,
                dtype=jnp.float32)["score"],
        np.float64,
    )
    pair = np.full(len(pairs), -np.inf)
    segs = np.full((len(pairs), 3), -np.inf)
    for i, (n, k) in enumerate(zip(owner, k_of)):
        pair[n] = max(pair[n], s[i])
        segs[n, k] = s[i]
    return pair, segs


def alone(n_pairs=256, reps=5):
    """Kernel against dp_fill on the same pairs, scorer alone."""
    tables = ScoreTables.from_params(default_params())
    tdev = device_tables(tables)
    cfg = DPConfig()
    x = read_fast_seqs(C8F30)[0]
    x.qual = ""
    pairs = [
        (x, y, cfg.make_envelope(x, KmerIndex(y, cfg.kmer_len), VITERBI_CELL_SIZE))
        for y in cs.c8f30_reads(n_pairs, seed=1)
    ]
    rows = round128(max(len(y.seq) for _, y, _ in pairs))
    width = round128(max(sum(s.band_width for s in pack_strips(e)) for _, _, e in pairs))
    packed = PairBatch.build_packed(pairs, tables, width=width, max_y_len=rows)
    reach = align_kernel.scan_reach(packed.seg_width)
    pdev = device_batch(packed)
    strips, _, _ = _strip_batch(pairs, tables, rows)
    sdev = device_batch(strips)
    cells = sum(e.num_cells for _, _, e in pairs)
    scorers = {
        "kernel": lambda: align_kernel.viterbi_scores(tdev, pdev, reach=reach),
        "xla_dp_fill": lambda: dp_fill(
            tdev, sdev, mode="viterbi", return_matrices=False, dtype=jnp.float32
        )["score"],
    }
    for name, fn in scorers.items():
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        first = time.perf_counter() - t0
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            times.append(time.perf_counter() - t0)
        med = float(np.median(times))
        record(what="align_scorer_alone", scorer=name, pairs=n_pairs,
               strip_rows=len(strips.x_len), first_s=first, times_s=times,
               median_s=med, cells_per_s=cells / med)


def e2e(order=("kernel", "xla", "kernel", "xla", "xla", "kernel")):
    """CLI align of 256 reads, kernel and XLA routes in turns."""
    reads = cs.write_fastq(cs.WORK / "align256.fastq", cs.c8f30_reads(256, seed=3))
    argv = ["align", C8F30, reads]
    kernel_route = QuaffAligner._score_chunk
    outs = set()
    try:
        for name in order:
            QuaffAligner._score_chunk = kernel_route if name == "kernel" else xla_score_chunk
            t0 = time.perf_counter()
            outs.add(cs.cli(argv))
            dt = time.perf_counter() - t0
            record(what="align_cli_256", scorer=name, seconds=dt, reads_per_s=256 / dt)
    finally:
        QuaffAligner._score_chunk = kernel_route
    record(what="align_cli_outputs_equal", equal=len(outs) == 1)


def estep(reps=3):
    """EM iterations (E-step counts + M-step refit) at 128 reads; the
    first includes its compiles."""
    from quaff_tpu.model.params import QuaffNullParams, QuaffParamCounts
    from quaff_tpu.trainer import QuaffCounter

    x = read_fast_seqs(C8F30)[0]
    x.qual = ""
    reads = cs.c8f30_reads(128, seed=4)
    null = QuaffNullParams.fit(reads)
    qp = default_params()
    cfg = DPConfig(dtype=jnp.float32)
    for i in range(reps + 1):
        t0 = time.perf_counter()
        counts, ll, _ = QuaffCounter(qp, null, cfg).get_counts([x], reads)
        fitted = QuaffParamCounts.zero(qp.match_kmer_len, qp.indel_kmer_len)
        fitted.add_weighted(counts, 1.0)
        qp = fitted.fit()
        record(what="em_iteration_128", iteration=i,
               seconds=time.perf_counter() - t0, loglike=ll)


def overlap(reps=2):
    """CLI overlap of 64 reads all-vs-all; the first run compiles."""
    reads = cs.write_fastq(cs.WORK / "overlap64.fastq", cs.overlap_reads(64, seed=5))
    for i in range(reps + 1):
        t0 = time.perf_counter()
        out = cs.cli(["overlap", reads])
        dt = time.perf_counter() - t0
        record(what="overlap_cli_64", run=i, seconds=dt, pairs_per_s=64 * 63 / 2 / dt,
               alignments=out.count("#=GS") // 2)


def _worst_over_tol(a, b):
    """Largest |a - b| / (5e-3 + 5e-3 |b|) over the numbers of two JSON
    values of one shape."""
    if isinstance(a, dict):
        return max((_worst_over_tol(a[k], b[k]) for k in a), default=0.0)
    if isinstance(a, list):
        return max((_worst_over_tol(p, q) for p, q in zip(a, b)), default=0.0)
    if isinstance(a, (int, float)):
        return abs(a - b) / (5e-3 + 5e-3 * abs(b))
    return 0.0


def train_mesh(n_reads=64, iters=2):
    """CLI train over every attached GPU (-mesh) against one GPU, in the
    order mesh, one, mesh, one: the first run of each kind includes its
    compiles, the second is warm."""
    reads = cs.write_fastq(cs.WORK / f"mesh{n_reads}.fastq", cs.c8f30_reads(n_reads, seed=7))
    base = ["train", C8F30, reads, "-fwdstrand", "-maxiter", str(iters)]
    fitted = {}
    for run, mesh in enumerate((True, False, True, False)):
        t0 = time.perf_counter()
        out = json.loads(cs.cli(base + (["-mesh"] if mesh else [])))
        dt = time.perf_counter() - t0
        fitted.setdefault(mesh, out)
        record(what="train_cli", mesh=mesh, devices=len(jax.devices()) if mesh else 1,
               reads=n_reads, em_iterations=iters, run="first" if run < 2 else "warm",
               seconds=dt)
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0) for d in jax.devices()]
    record(what="train_mesh_vs_one", worst_param_err_over_tol=_worst_over_tol(
        fitted[True], fitted[False]), peak_bytes_in_use=peaks)


MEASUREMENTS = {"alone": alone, "e2e": e2e, "estep": estep, "overlap": overlap,
                "train-mesh": train_mesh}


def main():
    global _out, _card
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", nargs="*",
                    help=f"any of {', '.join(MEASUREMENTS)} "
                    "(default: all but train-mesh)")
    ap.add_argument("--out", help="also append the JSON lines to this file")
    args = ap.parse_args()
    unknown = set(args.what) - set(MEASUREMENTS)
    if unknown:
        ap.error(f"unknown measurement(s): {', '.join(sorted(unknown))}")
    if jax.devices()[0].platform != "gpu":
        sys.exit("gpu_measure: no GPU; nothing measured")
    _card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    if args.out:
        _out = open(args.out, "a")
    from quaff_tpu import native

    native.get_lib(auto_build=True)
    cs.WORK.mkdir(exist_ok=True)
    for name in args.what or ["alone", "e2e", "estep", "overlap"]:
        MEASUREMENTS[name]()


if __name__ == "__main__":
    main()
