"""Host ms inside the datapath's ``classify_async`` a dispatch (pack,
upload and the step's enqueue), mean over the traced run's host-timed
part."""


def read(rec):
    a, b = rec["part1"]
    ms = [(e - s) / 1e6 for n, s, e in rec["spans"]
          if n == "enqueue" and a <= s < b]
    return sum(ms) / len(ms) if ms else None
