"""Device bytes of the placed policy snapshot (the verdict image, the LPM
tries and the other policy planes), from the datapath's own ledger
(``TorchDatapath.hbm_ledger``) once the window has closed."""

GROUPS = ("verdict", "tries", "policy")


def read(rec):
    n = sum(rec["placed_bytes"].get(g, 0) for g in GROUPS)
    return n or None
