"""Share (%) of K1's device time (``lpm_lookup_kernel``: the LPM walk, a
v4 row on the v4 trie, a v6 row on the v6 trie) that its bytes bound would
take, computed as ``verdict_roofline`` computes K3's. No launch traced, or
no dispatch checked: no value."""

from benchmark.metrics.verdict_roofline import kernel_roofline


def read(rec):
    return kernel_roofline(rec, "lpm_lookup_kernel")
