"""The probe path: one module per TPU probe file of ``benchmarks/``
(``probe_kernel_cost``, ``probe_r4``, ``probe_floor_chunk``,
``probe_floor_noread``), each running that file's variants on the card
through the CUDA probe kernels of ``ops/probe.py``:

    python -m metakssd_tpu_torch.probes.probe_kernel_cost

Together they split the cost of the compact sketch kernel K1 on the card
into its read floor, window math, table search and launch overhead.
"""
