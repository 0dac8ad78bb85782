"""``BENCHMARK.json`` within its contract's letters: names, units and the
files each entry names."""

import json
import os
import re

import pytest

from benchmark.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_and_units(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [w[k] for w in bench["workloads"] for k in ("config",
                                                         "traffic")]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names
                                               if not NAME.match(n)]
    assert all(UNIT.match(m["unit"])
               for m in bench["end_to_end"] + bench["per_layer"])
    for key in ("end_to_end", "per_layer", "configs", "workloads"):
        got = [m["name"] for m in bench[key]]
        assert len(got) == len(set(got)), key


def test_every_name_finds_its_files(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "metrics",
                                           f"{m['name']}.py"))
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "configs",
                                           f"{c['name']}.py"))
    for w in bench["workloads"]:
        assert w["config"] in configs
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "traffic",
                                           f"{w['traffic']}.json"))
        assert w["chips"] in (1, 4)


def test_every_cell_reports_what_its_metrics_move(bench):
    """Each cell reports ``setup_s`` and one more end-to-end metric, one
    per-layer metric at least, and the end-to-end metric that each of its
    per-layer metrics moves."""
    cells = [w["name"] for w in bench["workloads"]]

    def of(metric, cell):
        return cell in metric.get("workloads", cells)
    for cell in cells:
        e2e = {m["name"] for m in bench["end_to_end"] if of(m, cell)}
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        layer = [m for m in bench["per_layer"] if of(m, cell)]
        assert layer, cell
        for m in layer:
            assert m["moves"] in e2e, (cell, m["name"])
