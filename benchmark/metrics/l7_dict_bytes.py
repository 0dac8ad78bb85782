"""Device bytes of the L7 path dictionary, from the datapath's own ledger
(``TorchDatapath.hbm_ledger``'s ``l7_dict`` group, the dictionary last
placed, summed over its devices) once the window has closed. A program
that has placed no dictionary, or whose ledger has no such group: no
value."""


def read(rec):
    n = rec["placed_bytes"].get("l7_dict")
    return n or None
