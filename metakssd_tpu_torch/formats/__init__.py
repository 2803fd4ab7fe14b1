"""Byte-compatible codecs for every on-disk artifact of the reference engine.

These artifacts double as the checkpoint/resume system: every pipeline
stage persists a complete, self-describing directory, so pipelines restart
at any stage boundary (see reference behaviour around cofiles.stat /
mcofiles.stat / sharedk_ct.dat).
"""

from metakssd_tpu_torch.formats.shuf import DimShuffle, read_shuf, write_shuf, make_shuf  # noqa: F401
from metakssd_tpu_torch.formats.costat import CoStat, McoStat  # noqa: F401
from metakssd_tpu_torch.formats.codir import CoDir, write_codir  # noqa: F401
