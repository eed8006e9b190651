"""Benchmark: banded Viterbi throughput of the align kernel on the c8f30
align config, on an NVIDIA GPU.

    python bench.py

The headline is the steady-state in-envelope DP cells/s of the production
align scorer (dp/align_kernel.viterbi_scores: device-side row tables + the
Pallas kernel compiled through Triton, float32), fenced with
block_until_ready, on the reference's integration-test workload: the
6,604-base nanopore read c8f30 aligned against itself with k-mer seeding
(k=6, threshold 14, band 64 — the reference's default align banding,
diagenv.h:12-18).  The "extra" field adds one end-to-end CLI `align` pass
over 256 mutated c8f30 reads (chip_smoke.py's align workload), made after
the headline in the same process.

Prints ONE JSON line naming the device (platform, device_kind, count,
and nvidia-smi's name and power limit).  Without a GPU it exits non-zero
and prints no metric.
"""

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"


def _device():
    """The device this bench runs on; exits non-zero without a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(
            f"bench: no GPU found (JAX's default platform is "
            f"{devs[0].platform!r}); nothing measured"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "nvidia_smi": smi,
    }


def main():
    device = _device()
    result = _headline()
    result["device"] = device
    result["extra"].update(_align_pass())
    print(json.dumps(result))


def _headline(batch_size: int = 2048, n_warm: int = 2, n_iters: int = 5):
    """The align kernel alone on batch_size copies of the c8f30 pair:
    median of n_iters runs, each fenced with block_until_ready."""
    import jax

    from quaff_tpu.dp import align_kernel
    from quaff_tpu.dp.engine import PairBatch, device_batch, device_tables
    from quaff_tpu.dp.scores import ScoreTables
    from quaff_tpu.envelope import make_envelope
    from quaff_tpu.io.fastseq import KmerIndex, read_fast_seqs
    from quaff_tpu.model.params import default_params

    y = read_fast_seqs(str(DATA / "c8f30.fastq.gz"))[0]
    x = read_fast_seqs(str(DATA / "c8f30.fastq.gz"))[0]
    x.qual = ""

    tables = ScoreTables.from_params(default_params())
    env = make_envelope(x, KmerIndex(y, 6), kmer_threshold=14, cell_size=24)
    # production align layout: lane-packed strips (this workload's
    # 415-wide 3-cluster bounding band packs into ~206 member lanes)
    batch = PairBatch.build_packed([(x, y, env)] * batch_size, tables)
    tdev = device_tables(tables)
    bdev = device_batch(batch)
    reach = align_kernel.scan_reach(batch.seg_width)

    def run():
        return jax.block_until_ready(
            align_kernel.viterbi_scores(tdev, bdev, reach=reach)
        )

    for _ in range(n_warm):  # compile + warm
        run()
    times = []
    for _ in range(n_iters):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    return {
        "metric": "banded_viterbi_cells_per_sec",
        "value": env.num_cells * batch_size / dt,
        "unit": "DP cells/s (in-envelope, c8f30 align config, f32)",
        "extra": {"align_kernel_seconds": dt, "align_kernel_pairs": batch_size},
    }


def _align_pass(n_reads: int = 256):
    """One CLI `align` of n_reads mutated c8f30 copies against c8f30
    (envelope prep, kernel scoring, f64 winner refill and traceback,
    Stockholm output).  Its first-call compiles are included unless the
    compile cache holds them."""
    import contextlib
    import io

    import chip_smoke
    from quaff_tpu.cli import main as cli_main
    from quaff_tpu.device import DISPATCHES

    chip_smoke.WORK.mkdir(exist_ok=True)
    reads = chip_smoke.write_fastq(
        chip_smoke.WORK / f"align{n_reads}.fastq",
        chip_smoke.c8f30_reads(n_reads, seed=3),
    )
    before = DISPATCHES["align"]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["align", str(DATA / "c8f30.fastq.gz"), reads])
    dt = time.perf_counter() - t0
    if rc != 0 or "Score" not in out.getvalue() or DISPATCHES["align"] == before:
        sys.exit("bench: align pass failed or made no device dispatch")
    return {
        "align_pass_seconds": dt,
        "align_pass_reads": n_reads,
        "align_pass_reads_per_sec": n_reads / dt,
    }


if __name__ == "__main__":
    main()
