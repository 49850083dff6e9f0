"""monica_tpu — a real-time metagenomic classification engine on JAX,
run on an NVIDIA GPU (the package name is historical).

A from-scratch re-design of the capabilities of DrQuestion/monica (a
minimap2/mappy-wrapping CPU pipeline, see its `monica/monica.py`) built
on jax/XLA:

* the genome "database + .mmi index" stage (`monica/genomes/database.py`,
  `monica/genomes/aligner.py:31-62` in the reference) becomes a packed
  reference array + sorted minimizer table resident in HBM
  (:mod:`monica_tpu.index`);
* the per-read mappy alignment loop (`monica/genomes/aligner.py:179-279`)
  becomes a batched, jit-compiled seed→chain→extend pipeline with a
  CUDA banded Smith–Waterman kernel (:mod:`monica_tpu.ops`,
  :mod:`monica_tpu.align`);
* scaling is via `shard_map` over a ('data', 'index') device mesh with
  XLA collectives (:mod:`monica_tpu.parallel`) instead of thread pools;
* abundance accumulation/normalization (`aligner.py:282-319`) is a
  device-resident count table (:mod:`monica_tpu.stats`).
"""

__version__ = "0.1.0"

from monica_tpu.utils.units import human_readable  # noqa: F401
