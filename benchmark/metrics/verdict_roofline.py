"""Share (%) of K3's device time (``policy_verdict_kernel``: the policy
ladder, the verdict and, on a row under an L7 rule set, the request's
match) that its bytes bound would take, computed as ``kernels_roofline``
computes the three kernels' share, for this kernel alone. No launch
traced, or no dispatch checked: no value."""

from benchmark.harness.kernel_bytes import HBM_BYTES_PER_S


def kernel_roofline(rec, symbol):
    """One kernel's share: launches × (mean bytes a dispatch needs ÷
    3.35 TB/s) over its device time, both in the traced part."""
    tr, per = rec.get("trace"), rec.get("kernel_bytes")
    if not tr or not per:
        return None
    names = [n for n in tr["kernel_s"] if symbol in n]
    launches = sum(tr["launches"][n] for n in names)
    device_s = sum(tr["kernel_s"][n] for n in names)
    if not launches or device_s <= 0:
        return None
    mean_bytes = sum(d[symbol] for d in per) / len(per)
    return 100.0 * launches * mean_bytes / HBM_BYTES_PER_S / device_s


def read(rec):
    return kernel_roofline(rec, "policy_verdict_kernel")
