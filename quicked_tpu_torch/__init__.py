"""quicked_tpu_torch — the PyTorch/CUDA port of quicked_tpu.

The batched QuickEd cascade (windowed bound, banded score, Hirschberg
under the proven bound) on an NVIDIA H100 through hand-written CUDA
kernels (`csrc/`), bit-identical to the JAX package `quicked_tpu`, which
stays the reference. The port imports nothing of `quicked_tpu`: it keeps
its own copies of the host-only modules it needs (dna, cigar, params,
generate, ops.batch_prep, ops.myers_np, utils.profiler, and the host C
runtime in native/, which builds into build/quicked_tpu_torch/).

Public surface: `api.BatchAligner`, `api.align_batch`,
`api.QuickedAligner`, `api.align_pair`. Every entry takes `device`
("cuda" by default; "cpu" runs the kernels' plain PyTorch versions).
"""
