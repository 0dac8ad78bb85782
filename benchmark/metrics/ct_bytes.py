"""Device bytes of the conntrack table, from the datapath's own ledger
(``TorchDatapath.hbm_ledger``'s ``ct`` group) once the window has
closed."""


def read(rec):
    n = rec["placed_bytes"].get("ct")
    return n or None
