"""Measure the reference binary's performance baseline on this host.

Builds nothing itself — run tools/oracle/build_ref.sh first.  Reports:

1. pure banded-Viterbi fill cells/s via a two-point fit: the c8f30
   self-align (qmodel.cpp:1512-1560 is the hot ctor) is timed at two
   seed thresholds (14 -> 1,277,030 in-envelope cells; 1000 -> 428,204
   cells, the diagonal-0 band only); the slope removes the shared
   startup/IO/null-fit/traceback overhead.
2. end-to-end align wall (single c8f30 read, threshold 14) -> reads/s.
3. EM-iteration wall: train -maxiter 3 minus -maxiter 1, halved.
4. synth12 12-read align wall -> reads/s at 300 bp reads.

Each timing is the median of N runs (this VM has bursty CPU steal —
see CLAUDE.md).  Prints one JSON object; paste into BASELINE.md when
re-measuring on a new host.
"""

import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

QUAFF = "/tmp/quaffref/quaff"
DATA = pathlib.Path(__file__).resolve().parents[2] / "tests" / "data"
C8F30 = str(DATA / "c8f30.fastq.gz")

# every oracle run gets a scratch cwd: the reference's TempDir creates
# tempdirN droppings in whatever directory it runs from (util.h:47)
SCRATCH = tempfile.mkdtemp(prefix="quaffref-baseline-")

CELLS_T14 = 1_277_030  # envelope cells, threshold 14 (quaff_tpu.envelope)
CELLS_T1000 = 428_204  # threshold 1000: the always-included diagonal-0 band
CELLS_FULL = 43_612_816  # -kmatchoff full matrix


def med(cmd, n=9):
    """Best-of-n wall time: this VM's bursty CPU steal only ever ADDS
    time, so the minimum is the robust estimator of the true cost (the
    median still carries steal; see CLAUDE.md performance notes)."""
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        subprocess.run(
            cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            cwd=SCRATCH,
        )
        ts.append(time.perf_counter() - t0)
    return min(ts)


def overlap_reads(n=8):
    """All-vs-all overlap workload: n substrings of c8f30 (1/3 to 1/2
    length, 5% substitutions) — the shape of chip_smoke.py's overlap
    workload."""
    import numpy as np

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    from quaff_tpu.io.fastseq import FastSeq, read_fast_seqs

    base = read_fast_seqs(C8F30)[0]
    rng = np.random.default_rng(0)
    L = len(base.seq)
    reads = []
    for i in range(n):
        s0 = int(rng.integers(0, L // 2))
        ln = int(rng.integers(L // 3, L // 2))
        seq = list(base.seq[s0 : s0 + ln])
        qual = list(base.qual[s0 : s0 + ln])
        for _ in range(int(len(seq) * 0.05)):
            p = int(rng.integers(0, len(seq)))
            seq[p] = "acgt"[int(rng.integers(0, 4))]
        reads.append(
            FastSeq(name=f"r{i}", seq="".join(seq), qual="".join(qual))
        )
    return reads


def main():
    if not pathlib.Path(QUAFF).exists():
        sys.exit("build the oracle first: tools/oracle/build_ref.sh")
    t14 = med([QUAFF, "align", C8F30, C8F30, "-kmatchn", "14",
               "-fwdstrand", "-nothreshold"])
    t1000 = med([QUAFF, "align", C8F30, C8F30, "-kmatchn", "1000",
                 "-fwdstrand", "-nothreshold"])
    fill_cells_per_sec = (CELLS_T14 - CELLS_T1000) / (t14 - t1000)
    # corroboration at 34x the cell count (fill >> overhead): the full
    # 6604x6604 matrix via -kmatchoff
    t_full = med([QUAFF, "align", C8F30, C8F30, "-kmatchoff",
                  "-fwdstrand", "-nothreshold"], n=5)
    full_fill_cells_per_sec = (CELLS_FULL - CELLS_T1000) / (t_full - t1000)
    tr1 = med([QUAFF, "train", C8F30, C8F30, "-kmatchn", "14",
               "-fwdstrand", "-force", "-maxiter", "1"], n=3)
    tr3 = med([QUAFF, "train", C8F30, C8F30, "-kmatchn", "14",
               "-fwdstrand", "-force", "-maxiter", "3"], n=3)
    t_synth = med([QUAFF, "align", str(DATA / "synth12-genome.fasta"),
                   str(DATA / "synth12.fastq"), "-kmatchn", "10",
                   "-nothreshold"])
    # all-vs-all overlap (qoverlap.cpp:312-334): 8 c8f30 substrings ->
    # 28 unordered pairs, rc included (the reference default)
    n_ov = 8
    ov_reads = overlap_reads(n_ov)
    ov_path = pathlib.Path(SCRATCH) / "ovreads.fastq"
    with open(ov_path, "w") as fh:
        for r in ov_reads:
            r.write_fastq(fh)
    t_ov = med([QUAFF, "overlap", str(ov_path), "-kmatchn", "14",
                "-nothreshold"], n=5)
    ov_pairs = n_ov * (n_ov - 1) // 2
    # 16-read point (120 pairs): pairs/s is N-independent for the
    # single-threaded reference; this corroborates the 8-read number at
    # 16 reads
    ov16_reads = overlap_reads(16)
    ov16_path = pathlib.Path(SCRATCH) / "ovreads16.fastq"
    with open(ov16_path, "w") as fh:
        for r in ov16_reads:
            r.write_fastq(fh)
    t_ov16 = med([QUAFF, "overlap", str(ov16_path), "-kmatchn", "14",
                  "-nothreshold"], n=3)
    print(json.dumps({
        "viterbi_fill_cells_per_sec": round(fill_cells_per_sec, 0),
        "viterbi_fill_cells_per_sec_fullmatrix": round(
            full_fill_cells_per_sec, 0
        ),
        "c8f30_align_wall_s": round(t14, 4),
        "c8f30_align_reads_per_sec": round(1.0 / t14, 3),
        "em_iter_wall_s": round((tr3 - tr1) / 2, 4),
        "synth12_align_reads_per_sec": round(12.0 / t_synth, 1),
        "overlap_wall_s": round(t_ov, 4),
        "overlap_pairs": ov_pairs,
        "overlap_pairs_per_sec": round(ov_pairs / t_ov, 3),
        "overlap16_wall_s": round(t_ov16, 4),
        "overlap16_pairs": 120,
        "overlap16_pairs_per_sec": round(120 / t_ov16, 3),
    }))


if __name__ == "__main__":
    main()
