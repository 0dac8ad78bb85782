"""The served path under load: the engine built from a declaration, the
benchmark's timers on it, and the closed loop that drives the window.

The timers wrap the engine's and the datapath's own calls on the instance
(nothing inside the program changes): each of the engine's six finalize
folds, and the datapath's ``classify_async`` (the step's enqueue). Each
call is kept as (name, start, end) on the host's epoch clock, so that a
reader can take the calls of one part of the window and a trace can name
what the host was doing in an idle gap. ``count_calls`` counts the
Python-level torch calls of the next dispatches (a ``TorchFunctionMode``
around ``classify_async`` and its finalize). ``capture`` keeps, for the
submissions it is given, what a check needs: the table as of the
dispatch's start and after it, the step's counters and ``now``. The
tables are copied on the datapath's stream under its table lock, in order
with the step, straight into host buffers (pinned on a card) that
``reserve`` made before the window: the card holds no copy of them, and
its peak is the deployment's own.
"""

from __future__ import annotations

import collections
import time
from collections import Counter
from typing import Dict, List, Optional

import numpy as np
import torch

from torch.overrides import TorchFunctionMode

FOLDS = {"metrics": ("metrics", "add_batch"),
         "flowmetrics": ("flowmetrics", "add_batch"),
         "blackbox": ("blackbox", "record_verdicts"),
         "audit_capture": ("auditor", "maybe_capture"),
         "rule_hits": (None, "_fold_rule_hits"),
         "salvage": (None, "_ct_salvage_apply")}


class TorchCalls(TorchFunctionMode):
    """Counts the torch calls made from Python on the thread that enters
    it, by name."""

    def __init__(self):
        super().__init__()
        self.calls = Counter()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls[getattr(func, "__name__", str(func))] += 1
        return func(*args, **(kwargs or {}))


def build_engine(decl: Dict, daemon: Dict, sizes: Dict, device: str):
    """The engine, its world declared through the public API in the
    declaration's order, and ``regenerate`` → (engine, regenerate's host
    seconds)."""
    from cilium_tpu_torch.model.labels import Labels
    from cilium_tpu_torch.model.rules import parse_rule
    from cilium_tpu_torch.model.services import Service
    from cilium_tpu_torch.runtime import DaemonConfig, Engine
    from cilium_tpu_torch.runtime.datapath import TorchDatapath
    cfg = DaemonConfig(device=device, ct_capacity=sizes["ct_capacity"],
                       batch_size=sizes["batch"], **daemon)
    eng = Engine(cfg, datapath=TorchDatapath(cfg))
    ctx = eng.ctx
    for step in decl["steps"]:
        (kind, body), = step.items()
        if kind == "endpoint":
            eng.add_endpoint(body["labels"], ips=tuple(body["ips"]),
                             ep_id=body["ep_id"])
        elif kind == "identity":
            ident = ctx.allocator.allocate(Labels.parse(body["labels"]))
            ctx.ipcache.upsert(body["prefix"], ident.id)
        elif kind == "cidr_identity":
            ident = ctx.allocator.allocate_cidr(body["cidr"])
            ctx.ipcache.upsert(body["prefix"], ident.id)
        elif kind == "service":
            ctx.services.upsert(Service(name=body["name"],
                                        namespace=body["namespace"],
                                        backends=tuple(body["backends"])))
        elif kind == "rules":
            eng.repo.add([parse_rule(doc) for doc in body])
        else:
            raise ValueError(f"unknown declaration step {kind!r}")
    t0 = time.perf_counter()
    eng.regenerate()
    return eng, time.perf_counter() - t0


class Recorder:
    """The benchmark's timers, call counter and captures on one engine."""

    def __init__(self, eng):
        self.eng, self.dp = eng, eng.datapath
        self.spans: List[tuple] = []
        self.calls: List[int] = []
        self._count = 0
        self._wanted: Dict[int, Dict] = {}
        self._free: List[Dict] = []
        self._cur: Optional[Dict] = None
        for name, (owner, attr) in FOLDS.items():
            obj = eng if owner is None else getattr(eng, owner)
            setattr(obj, attr, self._timed(getattr(obj, attr),
                                           f"fold.{name}"))
        self._async = self._timed(self.dp.classify_async, "enqueue")
        self._step = self.dp._classify
        self.dp.classify_async = self.classify_async
        self.dp._classify = self.classify

    def _timed(self, real, name):
        spans = self.spans

        def call(*args, **kw):
            t0 = time.time_ns()
            try:
                return real(*args, **kw)
            finally:
                spans.append((name, t0, time.time_ns()))
        return call

    def count_calls(self, n: int) -> None:
        self._count = n

    def reserve(self, tables: int) -> None:
        """Make host buffers for ``tables`` copies of the table."""
        ct = self.dp._cts[0]
        pin = next(iter(ct.values())).is_cuda
        self._free += [{k: torch.empty(v.shape, dtype=v.dtype,
                                       pin_memory=pin)
                        for k, v in ct.items()} for _ in range(tables)]

    def capture(self, batch, rec: Dict, before: bool = True) -> None:
        """Fill ``rec`` when ``batch`` is dispatched: the table after the
        step, and with ``before`` the table before it too."""
        rec["batch"] = {k: np.array(v) for k, v in batch.items()}
        rec["_into"] = [self._free.pop() if before else None,
                        self._free.pop()]
        self._wanted[id(batch["src"])] = rec

    def classify_async(self, placed, snap, batch, now, pre_steered=False):
        self._cur = self._wanted.pop(id(batch["src"]), None)
        try:
            if self._count <= 0:
                return self._async(placed, snap, batch, now, pre_steered)
            self._count -= 1
            with TorchCalls() as mode:
                fin = self._async(placed, snap, batch, now, pre_steered)
        finally:
            self._cur = None
        calls = self.calls

        def finalize():
            with TorchCalls() as more:
                res = fin()
            calls.append(sum(mode.calls.values()) + sum(more.calls.values()))
            return res
        return finalize

    def classify(self, placed, ct, batch, now, world_index):
        rec = self._cur
        if rec is not None:
            rec["now"] = int(now)
            before, after = rec.pop("_into")
            if before is not None:
                rec["ct_before"] = _copy(before, ct)
        out, new_ct, counters = self._step(placed, ct, batch, now,
                                           world_index)
        if rec is not None:
            rec["ct_after"] = _copy(after, new_ct)
            rec["counters"] = {k: v.clone() for k, v in counters.items()}
        return out, new_ct, counters


def _copy(into: Dict, table: Dict) -> Dict:
    """``table`` copied into the host buffers ``into``, in stream order."""
    for k, v in table.items():
        into[k].copy_(v, non_blocking=True)
    return into


class Loop:
    """The closed loop, on the calling thread: the traffic's batches (made
    before the window) are submitted with at most ``outstanding``
    unresolved, a GC tick every ``gc_every`` batches and the clock one
    ``step`` a batch; the oldest ticket is resolved whenever
    ``outstanding`` are out."""

    def __init__(self, eng, rec: Recorder, traffic, now0: int, step: int,
                 gc_every: int, outstanding: int, checked: Dict[int, Dict]):
        self.eng, self.rec, self.traffic = eng, rec, traffic
        self.now, self.step, self.gc_every = now0, step, gc_every
        self.outstanding = outstanding
        self.checked = checked           # window index → capture record
        self.batches: List[tuple] = []   # (submit ns, result ns, rows)
        self.errors: List[str] = []
        self.failed_rows = 0
        self.submitted_rows = 0
        self.t_first = self.t_first_ns = None
        self._out: "collections.deque" = collections.deque()

    def _resolve(self):
        t, ticket, n, rec = self._out.popleft()
        try:
            out = ticket.result(timeout=300)
            self.batches.append((t, time.time_ns(), n))
            if rec is not None:
                rec["out"] = {k: np.array(v) for k, v in out.items()}
        except Exception as e:          # counted as failed rows
            self.failed_rows += n
            self.errors.append(f"{type(e).__name__}: {e}")

    def run(self, until) -> float:
        """Feed while ``until()`` is true; → the host time
        (``perf_counter``) when the last ticket resolved."""
        i = 0
        while until():
            b = self.traffic.batch_at(i)
            rec = self.checked.get(i)
            if rec is not None:
                self.rec.capture(b, rec)
            if self.gc_every and i % self.gc_every == 0:
                self.eng.sweep_step(self.now)
            t = time.time_ns()
            if self.t_first is None:
                self.t_first, self.t_first_ns = time.perf_counter(), t
            try:
                ticket = self.traffic.submit(self.eng, i, self.now)
            except Exception as e:      # the run fails
                self.errors.append(f"submit: {type(e).__name__}: {e}")
                break
            n = int(b["valid"].sum())
            self.submitted_rows += n
            self._out.append((t, ticket, n, rec))
            self.now += self.step
            i += 1
            while len(self._out) >= self.outstanding:
                self._resolve()
        while self._out:
            self._resolve()
        return time.perf_counter()
