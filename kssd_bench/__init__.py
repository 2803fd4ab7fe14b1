"""The benchmark of metakssd_tpu_torch (see README.md)."""
