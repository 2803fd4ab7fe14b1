"""Post-processing ports of the reference Perl toolchain (src/*.pl)."""

from metakssd_tpu_torch.postprocess.poisson import poisson_abundance  # noqa: F401
from metakssd_tpu_torch.postprocess.cami import composite_to_cami_profile  # noqa: F401
