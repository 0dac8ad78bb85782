"""Python-level torch calls a dispatch (``classify_async`` and its
finalize, counted by a ``TorchFunctionMode``), mean over the counted
dispatches. A count: it repeats exactly while the code is the same."""


def read(rec):
    calls = rec["calls"]
    return sum(calls) / len(calls) if calls else None
