"""quaff-tpu: a pair-HMM engine for noisy long-read sequencing on GPUs.

A from-scratch reimplementation of the capabilities of quaff (pair-HMM
training / alignment / overlap detection for nanopore reads) for
accelerators: the banded dynamic-programming recursions run as batched,
vectorised JAX computations (log-semiring row scans with associative
in-row gap scans), data parallelism is expressed with jax.sharding /
shard_map over device meshes, and E-step counts are reduced with on-device
collectives instead of the reference's socket/qsub/EC2 task farm.

Layout:
  alphabet     tokenisation, k-mer packing, reverse complement
  io.fastseq   FASTA/FASTQ(.gz) parsing & writing, k-mer index
  model        parameters, null model, counts, negative-binomial fits,
               JSON round-trip (byte-compatible with the reference formats)
  envelope     k-mer diagonal seeding -> banded DP envelope
  dp           Viterbi / Forward / Backward+counts / overlap kernels
  formats      Stockholm / gapped-FASTA / SAM / refseq alignment output
  train        Baum-Welch EM driver
  parallel     mesh construction, sharded batch execution, count psums
  cli          quaff-compatible command-line driver
"""

__version__ = "0.1.0"
