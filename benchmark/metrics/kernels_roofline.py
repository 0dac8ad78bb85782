"""Share (%) of the three hand-written kernels' device time that their
bytes bound would take: Σ over K1–K3 of launches × (mean bytes a dispatch
needs ÷ 3.35 TB/s), over Σ of their device time, both in the traced part.
The bytes come from ``harness/kernel_bytes.py`` on the window's checked
dispatches; the device time and launches from the profiler's kernel
records. Nothing to read (no launch traced, or no dispatch checked): no
value."""

from benchmark.harness.kernel_bytes import HBM_BYTES_PER_S


def read(rec):
    tr, per = rec.get("trace"), rec["kernel_bytes"]
    if not tr or not per:
        return None
    bound_s = device_s = 0.0
    for symbol in per[0]:
        names = [n for n in tr["kernel_s"] if symbol in n]
        launches = sum(tr["launches"][n] for n in names)
        if not launches:
            return None
        mean_bytes = sum(d[symbol] for d in per) / len(per)
        bound_s += launches * mean_bytes / HBM_BYTES_PER_S
        device_s += sum(tr["kernel_s"][n] for n in names)
    return 100.0 * bound_s / device_s
