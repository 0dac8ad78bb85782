"""Share (%) of the traced part in which no operation ran on the device:
1 − (the union of the device operations' intervals ÷ the part's length),
from ``torch.profiler``."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
