"""device_idle: the share (%) of the traced window in which the device
ran neither a kernel nor a copy (``torch.profiler``)."""

from kssd_bench import tracing


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    window = tracing.window_seconds(run.trace)
    if window <= 0:
        return None
    return 100.0 * (1.0 - tracing.busy_seconds(run.trace) / window)
