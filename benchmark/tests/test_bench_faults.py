"""A run with the timed path broken underneath comes out not correct: a
step that leaves the table unchanged, half of each batch left out, and
one answer altered where it is produced; on the test-only v6 + L7 world
also the L7 verdict flipped on the rows that matched their set, and the
remote identities of v6 rows swapped among them (faults that a v4 world
without L7 rules cannot show). The harness's look for a card is skipped:
the run drives the port's CPU path."""

import numpy as np
import pytest
import torch

from benchmark.harness import serve
from benchmark.tests import v6_l7
from benchmark.tests.helpers import cpu_run


def state_unchanged(dp):
    real = dp._classify

    def step(placed, ct, batch, now, world_index):
        before = {k: v.clone() for k, v in ct.items()}
        out, _new_ct, counters = real(placed, ct, batch, now, world_index)
        for k, v in ct.items():
            v.copy_(before[k])
        return out, ct, counters
    dp._classify = step


def half_batch(dp):
    real = dp.classify_async

    def classify_async(placed, snap, batch, now, pre_steered=False):
        b = {k: np.array(v) for k, v in batch.items()}
        b["valid"][b["valid"].shape[0] // 2:] = False
        return real(placed, snap, b, now, pre_steered)
    dp.classify_async = classify_async


def answer_altered(dp):
    real = dp._classify

    def step(placed, ct, batch, now, world_index):
        out, new_ct, counters = real(placed, ct, batch, now, world_index)
        out = dict(out)
        out["allow"] = out["allow"].clone()
        out["allow"][0] = ~out["allow"][0]
        return out, new_ct, counters
    dp._classify = step


def l7_flipped(dp):
    real = dp._classify

    def step(placed, ct, batch, now, world_index):
        out, new_ct, counters = real(placed, ct, batch, now, world_index)
        out = dict(out)
        matched = out["redirect"] & out["allow"]
        out["allow"] = out["allow"] & ~matched
        out["reason"] = torch.where(matched, 180, out["reason"])
        return out, new_ct, counters
    dp._classify = step


def v6_identity_swapped(dp):
    real_async, real = dp.classify_async, dp._classify
    v6 = {}

    def classify_async(placed, snap, batch, now, pre_steered=False):
        v6["rows"] = torch.as_tensor(np.flatnonzero(batch["is_v6"]))
        return real_async(placed, snap, batch, now, pre_steered)

    def step(placed, ct, batch, now, world_index):
        out, new_ct, counters = real(placed, ct, batch, now, world_index)
        out = dict(out)
        rows = v6["rows"].to(out["remote_identity"].device)
        ident = out["remote_identity"].clone()
        ident[rows] = ident[rows.roll(1)]
        out["remote_identity"] = ident
        return out, new_ct, counters
    dp.classify_async = classify_async
    dp._classify = step


def _broken_run(monkeypatch, fault, name):
    real = serve.build_engine

    def build_engine(*args, **kw):
        eng, regen_s = real(*args, **kw)
        fault(eng.datapath)
        return eng, regen_s
    monkeypatch.setattr(serve, "build_engine", build_engine)
    res, _notes = cpu_run(name)
    assert res["correct"] is False
    bad = {k: c["value"] for k, c in res["checks"].items()
           if "most" in c and c["value"] > c["most"]}
    assert bad


@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   answer_altered])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    _broken_run(monkeypatch, fault, "cfg5.serve")


@pytest.mark.parametrize("fault", [l7_flipped, v6_identity_swapped])
def test_a_broken_v6_or_l7_path_is_not_correct(fault, monkeypatch):
    _broken_run(monkeypatch, fault, v6_l7.NAME)
