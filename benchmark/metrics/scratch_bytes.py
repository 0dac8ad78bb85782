"""Device bytes at the window's peak beyond the placed tables: the step's
transient tensors and the datapath's device staging, that is the card's
peak (the caching allocator's, reset before the window) less the
datapath ledger's placed groups."""


def read(rec):
    peak = rec.get("memory_peak_bytes") or 0
    placed = sum(rec["placed_bytes"].values())
    return peak - placed if peak > placed else None
