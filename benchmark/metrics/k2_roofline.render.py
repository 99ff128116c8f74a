"""K2's share of its roofline over the traced passes, in %: the bytes
its queries need (each ray in, each hit out; ``lumobench/peaks.py``) at
the HBM peak, over the device time of its kernels."""
from lumobench import peaks


def read(run):
    if run.kind != "render" or not run.traces:
        return None
    need = sum(peaks.k2_bytes(t.host_ops) for t in run.traces)
    spent = sum(b - a for t in run.traces for name, a, b in t.device_ops
                if peaks.is_k2_kernel(name)) / 1e9
    if not need or spent <= 0:
        return None
    return 100.0 * need / peaks.HBM_BYTES_PER_S / spent
