"""cuhe_tpu_torch: the PyTorch / CUDA port of cuhe_tpu for NVIDIA Hopper.

The JAX package ``cuhe_tpu`` is the reference; this package mirrors its
module names and data layouts and imports nothing of it.  Its hand-written
kernels live in ``csrc/`` and are built with nvcc on first use
(``ops/_cuda.py``); every kernel front end runs its plain PyTorch version
for CPU tensors.  Entry points: ``entry.py`` and ``step.py``.
"""
