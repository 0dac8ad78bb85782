"""The engine's six finalize folds' host ms a batch (metrics, flow
metrics, flight recorder, audit capture, rule hits, CT-salvage note), over
the traced run's host-timed part: the folds' summed time over the number
of batches folded (one ``fold.metrics`` call a batch)."""


def read(rec):
    a, b = rec["part1"]
    spans = [(n, s, e) for n, s, e in rec["spans"]
             if n.startswith("fold.") and a <= s < b]
    batches = sum(1 for n, _s, _e in spans if n == "fold.metrics")
    if not batches:
        return None
    return sum(e - s for _n, s, e in spans) / 1e6 / batches
