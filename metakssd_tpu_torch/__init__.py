"""metakssd_tpu_torch — KSSD sketching and MarkerDB profiling in PyTorch
and CUDA, the port of ``metakssd_tpu`` to an NVIDIA H100.

It imports ``torch`` and never ``jax``.  The jax-free layers of
``metakssd_tpu`` (parameters, on-disk formats, native host I/O, the numpy
golden model, postprocessing) are imported, not copied; every module that
touched jax has its counterpart here, and every Pallas kernel on the
ported path is a hand-written CUDA kernel (``csrc/``) with a plain
PyTorch version beside it (``ops/sketch_cuda.py``, ``ops/merge.py``).
"""

__version__ = "0.1.0"
