"""A cell of ``BENCHMARK.json`` and the files it names, found by name:
``configs/<config>.json`` (the sizes as run) beside ``configs/<config>.py``
(the declaration), ``traffic/<traffic>.json`` (the mix's parameters),
``generators/<generator>.py`` (the code that the mix names under
``generator``) and ``metrics/<metric>.py`` for each per-layer metric the
cell reports.

A mix holds the loop's keys (``LOOP_KEYS``), ``generator``, and the keys
its generator lists in ``KEYS``; any other key is refused. A generator
module has ``KEYS`` and ``make(mix, decl, policy, batch, seed, flows)``,
which returns the run's traffic: ``warm_batches()`` (the warm-up's
batches), ``batch_at(i)`` (the window's ``i``-th batch, made before the
window; each has a ``src`` array of its own), ``submit(eng, i, now)``
(submits it, → the ticket), ``live_allowance(close_batches)`` (the most
live table entries the window may leave above the warm-up's) and
``close()`` (called once the window has closed)."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


#: the mix keys the run's loop reads (``harness/runner.py``)
LOOP_KEYS = ("outstanding", "flows", "test_flows", "clock_step_s",
             "gc_every_s", "checked_dispatches", "checked_from",
             "test_checked_from")


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict
    declare: object                  # the config module
    traffic_name: str
    traffic: Dict
    generator: object                # the generator module
    end_to_end: List[Dict] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)
    readers: Dict[str, object] = field(default_factory=dict)


def _module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark, loaded by its path (a
    name may hold ``.`` or ``-``)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}._{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_mix(name: str, mix: Dict, generator) -> None:
    """Refuse a mix key that neither the loop nor its generator reads."""
    unknown = set(mix) - set(LOOP_KEYS) - set(generator.KEYS) \
        - {"generator"}
    if unknown:
        raise ValueError(f"mix {name!r}: keys that nothing reads: "
                         f"{sorted(unknown)}")


def _reports(metric: Dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load(workload: str, manifest: str = None) -> Cell:
    with open(manifest or os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    with open(os.path.join(HERE, "configs", f"{w['config']}.json")) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    generator = _module("generators", traffic["generator"])
    check_mix(w["traffic"], traffic, generator)
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, names)]
    return Cell(
        name=workload, chips=int(w["chips"]), config_name=w["config"],
        config=config,
        declare=_module("configs", w["config"]),
        traffic_name=w["traffic"], traffic=traffic, generator=generator,
        end_to_end=e2e,
        per_layer=per_layer,
        readers={m["name"]: _module("metrics", m["name"])
                 for m in per_layer})
