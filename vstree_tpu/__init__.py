"""vstree_tpu — an accelerator sequence-analysis framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
vstree toolkit (mkvtree enhanced-suffix-array construction + vmatch
large-scale matching): persistent enhanced suffix arrays, exact and
approximate match enumeration (repeats, MUMs/MEMs, tandems, complete
matches), seed extension, statistics, chaining/clustering
postprocessing, and reference-compatible index files and match output.

Layering (bottom-up), mirroring the reference's five-layer build:

- :mod:`vstree_tpu.core`      — alphabets, multi-sequence model, parsing
- :mod:`vstree_tpu.index`     — ESA construction + reference-format I/O
- :mod:`vstree_tpu.ops`       — device kernels (sorts, DP, interval ops)
- :mod:`vstree_tpu.engine`    — match enumeration engines
- :mod:`vstree_tpu.stats`     — E-values, Karlin-Altschul
- :mod:`vstree_tpu.postprocess` — chaining, clustering, masking, selection
- :mod:`vstree_tpu.output`    — vmatch-compatible match rendering
- :mod:`vstree_tpu.parallel`  — mesh sharding of build and query
- :mod:`vstree_tpu.cli`       — mkvtree / vmatch / tool entry points
"""

__version__ = "0.1.0"
