"""What the v6 and L7 additions leave exactly as it was, held to readings
taken before them: every batch of the existing mixes at test sizes (the
warm-up and one period of the window), and the kernels' byte counts of
cfg3.serve's checked dispatches at test sizes. Also: a v6 row counts its
v6 walk, and an L7 row its request and the set it reaches."""

import hashlib

import numpy as np
import pytest

from benchmark.harness import kernel_bytes, runner
from benchmark.tests.helpers import SEED, cpu_run
from benchmark.tests.test_bench_traffic import _traffic

BATCHES = {
    "cfg5.serve": "8b19359fd57917bbf9aa6b7df970e04a593b23605d139d5f7bfb02ad"
                  "93ed02ae",
    "cfg3.serve": "6742439373aabb4bdadd9fcb5efbbd140a82b1f5d22c10dea0f135e6"
                  "9a57bc0c",
}

CFG3_BYTES = [
    {"lpm_lookup_kernel": 33552, "ct_probe_pair_kernel": 175672,
     "policy_verdict_kernel": 41453},
    {"lpm_lookup_kernel": 33696, "ct_probe_pair_kernel": 176320,
     "policy_verdict_kernel": 41437},
]


def batches_digest(traffic) -> str:
    h = hashlib.sha256()
    for b in [*traffic.warm_batches(),
              *(traffic.batch_at(i) for i in range(traffic.period))]:
        for k in sorted(b):
            a = np.ascontiguousarray(b[k])
            h.update(f"{k}:{a.dtype.str}:{a.shape}".encode())
            h.update(a.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_the_mixes_make_the_batches_they_made(name):
    _c, _d, _s, traffic = _traffic(name, SEED)
    assert batches_digest(traffic) == BATCHES[name]


def test_cfg3_dispatches_count_the_bytes_they_counted(monkeypatch):
    got = []

    def dispatch_bytes(*args):
        got.append(kernel_bytes.dispatch_bytes(*args))
        return got[-1]
    monkeypatch.setattr(runner, "dispatch_bytes", dispatch_bytes)
    res, _notes = cpu_run("cfg3.serve")
    assert res["correct"] is True
    assert got == CFG3_BYTES


def _trie(levels):
    """A trie of ``levels`` chained nodes on byte 1, and a dead node."""
    t = np.full((levels + 1, 256, 3), -1, np.int32)
    for i in range(levels - 1):
        t[i, 1, 0] = i + 1
    return t


def test_a_v6_row_walks_the_v6_trie_and_an_l7_row_reads_its_set():
    v4, v6 = _trie(4), _trie(16)
    batch = {"direction": np.asarray([1, 1]), "is_v6": np.asarray([0, 1]),
             "src": np.asarray([[0, 0, 0xFFFF, 0x01010101],
                                [0x01010101] * 4], np.uint32),
             "dst": np.zeros((2, 4), np.uint32)}
    got = kernel_bytes.lpm_bytes(v4, v6, batch["src"], batch["is_v6"])
    # the v4 row: 4 cells of the v4 trie; the v6 row: 16 of the v6 one
    assert got == 2 * 16 + (4 + 16) * 12 + 2 * 8
    assert kernel_bytes.lpm_bytes(v4, v6, batch["src"][:1], [0]) \
        == 16 + 4 * 12 + 8
    b = {"valid": np.ones(3, bool), "ep_slot": np.zeros(3, np.int32),
         "direction": np.ones(3, np.int32), "proto": np.full(3, 6),
         "dport": np.asarray([80, 80, 81])}
    out = {"matched_rule": np.asarray([0, 0, 1]),
           "remote_identity": np.asarray([256, 257, 256])}
    plain = kernel_bytes.policy_bytes(b, out)
    assert kernel_bytes.policy_bytes(b, out, np.zeros(3, np.int64), 3) \
        == plain
    assert kernel_bytes.policy_bytes(b, out, np.asarray([2, 2, 0]), 3) \
        == plain + 2 * 65 + 1 * 3 * 70
