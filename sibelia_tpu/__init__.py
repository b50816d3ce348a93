"""sibelia_tpu — a synteny block / variant calling framework on JAX.

A ground-up re-design of the capabilities of bioinf/Sibelia 3.0.7 (synteny
block finding via iterative de Bruijn graph simplification, plus pairwise
variant calling) as array programs for JAX/XLA, with native C++ host
kernels as the reference path.

Layout:
  core/     config, stage presets, deterministic RNG parity helpers
  io/       FASTA reader/writer, all output writers (coords/coverage/perm/...)
  index/    device-side k-mer ranking and bifurcation enumeration
  graph/    mutable sequence arrays, bifurcation store, simplification
  blocks/   edge listing, overlap resolution, trimming, gluing, numbering
  variants/ batched alignment + variant extraction (C-Sibelia capability)
  parallel/ device mesh, sharded index build (multi-chip)
  kernels/  device alignment kernels (order band DP, batched Gotoh)
  cli/      command line drivers
"""

__version__ = "0.1.0"
VERSION = "3.0.7"  # reference compatibility version reported in outputs
