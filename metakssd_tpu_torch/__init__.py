"""metakssd_tpu_torch — KSSD sketching and MarkerDB profiling in PyTorch
and CUDA, the port of ``metakssd_tpu`` to an NVIDIA H100.

It imports ``torch``, numpy and the standard library, and never ``jax``
nor any module of ``metakssd_tpu``.  The host layers it shares with the
JAX package (parameters, on-disk formats, the native host I/O bindings,
the numpy golden model, postprocessing, ``reverse``) are copies at the
counterpart's path, with every jax or device route left out; every module
that touched jax has its counterpart here, and every Pallas kernel of the
repo is a hand-written CUDA kernel (``csrc/``) with a plain PyTorch
version beside it (``ops/sketch_cuda.py``, ``ops/merge.py``,
``ops/probe.py``).
"""

__version__ = "0.1.0"
