"""Host seconds of the set-up's ``Engine.regenerate()`` (the policy
compiler's ``build_snapshot`` and the placement)."""


def read(rec):
    return rec.get("regen_s")
