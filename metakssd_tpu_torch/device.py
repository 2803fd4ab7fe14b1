"""Device selection: the port's counterpart of
``metakssd_tpu.utils.backend_policy``.

The device is always named by the caller, and no environment variable
moves work off it:

* ``"cuda"`` (or ``"cuda:N"``) runs the CUDA kernels, and raises instead
  of falling back where there is no usable GPU;
* ``"cpu"`` runs the plain PyTorch version of every kernel (the tests'
  oracle, the CPU leg of the smoke run);
* ``"host"`` runs the JAX package's native host engine where that package
  runs it on a host without an accelerator (``backend_policy() ==
  "cpu"``): the C++ sketcher, the radix-sort unions, ``np.searchsorted``
  membership and the native posting passes, and the plain versions
  elsewhere.  Its torch work lies on the CPU and it never initialises
  CUDA; it raises where the host library cannot be built or loaded.

Every route asks ``engine`` once whether the host engine takes it, and
``resolve_device`` for its ``torch.device`` (the CPU for ``"host"``); no
route tests a device's name.
"""

from __future__ import annotations

import torch

HOST = "host"


def engine(name, shuf=None) -> bool:
    """Whether the native host engine takes a route asked for on ``name``:
    ``name`` is ``"host"`` and, for a sketch of ``shuf``, k - drlevel <= 8
    (the configs of ``sketch_xla.sketch_codes``'s host route).  Raises
    where ``"host"`` is asked for and the host library cannot load."""
    if not (isinstance(name, str) and name == HOST):
        return False
    from metakssd_tpu_torch.io import native
    native.require()
    if shuf is None:
        return True
    p = shuf.params
    return p.k - p.drlevel <= 8


def resolve_device(name) -> torch.device:
    """``"cuda"`` / ``"cuda:N"`` / ``"cpu"`` / ``"host"`` (or a
    ``torch.device``) -> ``torch.device``; raises when CUDA is asked for
    and absent, or the host engine's library for ``"host"``."""
    if engine(name):
        return torch.device("cpu")
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but "
                "torch.cuda.is_available() is False")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(dev)!r} (cuda, cpu or host)")
