"""The port's verifier (``compile/verifier.py``) against the JAX
package's, on the CPU, case for case with ``test_verifier.py``.

``TestVerifier`` and ``TestProfilerHook`` run the reference's bodies on
each package (``P("jax")``, ``P("torch")``), assert its expectations on
both and hold a side-neutral observation equal (``both``): the sweep's
combination names and accept flags, the budget's rejections, the CLI's
return code and its "combos verifier-accepted" line, and the profiled
step's first verdict with the fact that a trace was written (an xprof
directory on the JAX side, a Chrome trace on the port's). Each side's
sweep and CLI run are made once (module scope): the XLA compiles are
most of this file's time.

Beyond the mirrors: the reference compiles the classify step ahead of
time per combination; the port runs one step of it (torch compiles
nothing ahead of time), so the bytes differ by design and the rest is
held equal:

- the combination names and their accept flags equal
  ``verify_configs(quick=True)``'s;
- ``budget_doc`` has the reference's keys, and ``budget_doc`` and
  ``apply_budget`` (pure functions, copied) give the reference's answers
  on the same reports;
- the port's argument bytes are the placed tensors plus the CT;
- ``cilium-tpu-torch verify`` accepts every combination on the CPU and
  rejects them all under a one-byte budget.
"""

import dataclasses
import functools
import importlib
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

import cilium_tpu.compile.verifier as jv
import cilium_tpu_torch.compile.verifier as tv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = ("jax", "torch")
PKG = {"jax": "cilium_tpu", "torch": "cilium_tpu_torch"}
ORACLE = {"jax": "oracle", "torch": "cilium_tpu_torch.oracle"}


def P(side):
    """``side``'s verifier, CLI module and the names the profiler case
    imports (the port's ``DaemonConfig`` and sweep on the CPU; its
    ``TorchDatapath`` under the reference's ``JITDatapath`` name)."""
    pkg = PKG[side]
    mod = importlib.import_module
    ver = mod(f"{pkg}.compile.verifier")
    dp = mod(f"{pkg}.runtime.datapath")
    ns = dict(
        side=side, cli=f"{pkg}.cli.main",
        verify_configs=ver.verify_configs, apply_budget=ver.apply_budget,
        batch_from_records=mod(f"{pkg}.kernels.records").batch_from_records,
        DaemonConfig=mod(f"{pkg}.runtime.config").DaemonConfig,
        JITDatapath=(dp.TorchDatapath if side == "torch"
                     else dp.JITDatapath),
        Engine=mod(f"{pkg}.runtime.engine").Engine,
        C=mod(f"{pkg}.utils.constants"),
        parse_addr=mod(f"{pkg}.utils.ip").parse_addr,
        PacketRecord=mod(ORACLE[side]).PacketRecord)
    if side == "torch":
        ns["DaemonConfig"] = functools.partial(ns["DaemonConfig"],
                                               device="cpu")
        ns["verify_configs"] = functools.partial(ns["verify_configs"],
                                                 device="cpu")
    return SimpleNamespace(**ns)


def both(case):
    obs = {s: case(P(s)) for s in SIDES}
    assert obs["jax"] == obs["torch"]
    return obs["torch"]


@pytest.fixture(scope="module")
def sweeps():
    # ONE compile sweep a side serves every assertion (budget checks are
    # pure post-processing of the memory stats)
    return {s: P(s).verify_configs(batch=64, quick=True) for s in SIDES}


@pytest.fixture(scope="module")
def reference(sweeps):
    return sweeps["jax"]


@pytest.fixture(scope="module")
def port(sweeps):
    return sweeps["torch"]


@functools.lru_cache(maxsize=None)
def cli_verify(side, *extra):
    """One ``verify --batch 64 --quick`` run of ``side``'s CLI a set of
    extra arguments (the port's with ``--device cpu``), shared by the
    cases that read it. → (returncode, stdout, stderr, report JSON or
    None)."""
    import json
    import tempfile
    args = [sys.executable, "-m", P(side).cli, "verify", "--batch", "64",
            "--quick", *extra]
    with tempfile.TemporaryDirectory() as tmp:
        report = os.path.join(tmp, "verify.json")
        if side == "torch":
            args += ["--device", "cpu", "--report", report]
        out = subprocess.run(args, capture_output=True, text=True,
                             timeout=300, cwd=ROOT,
                             env={**os.environ, "JAX_PLATFORMS": "cpu"})
        doc = None
        if os.path.exists(report):
            with open(report) as f:
                doc = json.load(f)
    return out.returncode, out.stdout, out.stderr, doc


def _accepted_line(stdout):
    return [ln for ln in stdout.splitlines()
            if "combos verifier-accepted" in ln]


class TestVerifier:
    def test_all_combos_compile(self, sweeps):
        @both
        def _(m):
            sweep = sweeps[m.side]
            assert len(sweep) >= 10
            bad = [(r.name, r.error) for r in sweep if not r.ok]
            assert not bad, bad
            names = {r.name for r in sweep}
            # the key shapes are all present
            assert "v4only+v4" in names
            assert "dual+l7+l7dict" in names
            assert "dual+addr" in names
            assert "rule-padded" in names
            return [(r.name, r.ok) for r in sweep]

    def test_memory_budget_rejects(self, sweeps):
        @both
        def _(m):
            sweep = sweeps[m.side]
            reports = m.apply_budget(sweep, max_hbm_bytes=1)
            assert any(not r.ok and "memory budget" in r.error
                       for r in reports)
            # the original sweep is budget-free and still all-ok
            assert all(r.ok for r in sweep)
            return ([(r.name, r.ok, "memory budget" in (r.error or ""))
                     for r in reports], [r.ok for r in sweep])

    def test_cli_verify(self):
        @both
        def _(m):
            rc, stdout, stderr, _doc = cli_verify(m.side)
            assert rc == 0, stderr
            assert "combos verifier-accepted" in stdout
            assert "FAIL" not in stdout
            return rc, _accepted_line(stdout)


class TestProfilerHook:
    def test_profile_classify_writes_trace(self, tmp_path):
        @both
        def _(m):
            C, PacketRecord, parse_addr = m.C, m.PacketRecord, m.parse_addr
            eng = m.Engine(m.DaemonConfig(ct_capacity=1024,
                                          auto_regen=False),
                           datapath=m.JITDatapath(m.DaemonConfig(
                               ct_capacity=1024, auto_regen=False)))
            eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",),
                             ep_id=1)
            eng.apply_policy([{
                "endpointSelector": {"matchLabels": {"app": "web"}},
                "egress": [{"toCIDR": ["10.0.0.0/8"]}]}])
            eng.regenerate()
            s16, _ = parse_addr("192.168.1.10")
            d16, _ = parse_addr("10.1.2.3")
            batch = m.batch_from_records(
                [PacketRecord(s16, d16, 40000, 443, C.PROTO_TCP, C.TCP_SYN,
                              False, 1, C.DIR_EGRESS)],
                eng.active.snapshot.ep_slot_of)
            trace_dir = str(tmp_path / m.side / "xprof")
            out = eng.profile_classify(batch, trace_dir, now=1000)
            assert bool(out["allow"][0])
            # a plugin trace directory with at least one event file exists
            found = []
            for root, _dirs, files in os.walk(trace_dir):
                found.extend(files)
            assert found, "no trace files written"
            return bool(out["allow"][0]), bool(found)


# --------------------------------------------------------------------------- #
# beyond the mirrors: the port's sweep and CLI against the reference's
# --------------------------------------------------------------------------- #
def test_names_and_accept_flags_equal_the_reference(reference, port):
    assert [(r.name, r.ok) for r in port] == \
        [(r.name, r.ok) for r in reference]
    assert all(r.ok for r in port), [(r.name, r.error) for r in port]
    full = tv.verify_configs(batch=16, quick=False, device="cpu")
    assert {"dual+lb+dict", "v4only+l7+lb+l7dict"} <= {r.name for r in full}
    assert all(r.ok for r in full)


def test_budget_doc_keys_equal_the_reference(reference, port):
    dj, dt = jv.budget_doc(reference), tv.budget_doc(port)
    assert set(dj) == set(dt)
    assert dj["combos"] == dt["combos"] and dj["accepted"] == dt["accepted"]
    assert dt["rejected"] == [] and dt["worst_total_bytes"] > 0


def test_budget_functions_equal_the_reference_on_the_same_reports(port):
    as_jax = [jv.ComboReport(**dataclasses.asdict(r)) for r in port]
    for budget in (None, 1, port[0].argument_bytes + 1):
        if budget is None:
            rj, rt = as_jax, port
        else:
            rj = jv.apply_budget(as_jax, budget)
            rt = tv.apply_budget(port, budget)
        assert [dataclasses.asdict(r) for r in rj] == \
            [dataclasses.asdict(r) for r in rt]
        assert jv.budget_doc(rj, budget) == tv.budget_doc(rt, budget)
    rejected = tv.apply_budget(port, 1)
    assert not any(r.ok for r in rejected)
    assert all("memory budget" in r.error for r in rejected)
    assert all(r.ok for r in port)      # the sweep itself is untouched


def test_argument_bytes_are_the_placed_tensors_plus_the_ct(port):
    from cilium_tpu_torch.compile.ct_layout import make_ct_arrays
    from cilium_tpu_torch.convert import snapshot_tensors_to_torch
    snap = tv._build_world(l7=True, lb=False, v6=True)
    tensors = snapshot_tensors_to_torch(snap.tensors(), "cpu")
    ct = make_ct_arrays(snap.ct_config, device="cpu")
    want = sum(t.numel() * t.element_size()
               for d in (tensors, ct) for t in d.values())
    got = {r.name: r for r in port}["dual+l7+dict"]
    assert got.argument_bytes == want
    assert got.temp_bytes == 0            # no device peak on the CPU
    assert got.output_bytes > 0


def test_cuda_without_a_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tv.verify_configs(quick=True)


@pytest.mark.parametrize("extra,rc", [([], 0),
                                      (["--max-hbm-bytes", "1"], 1)])
def test_cli_verify(extra, rc):
    got, stdout, stderr, report = cli_verify("torch", *extra)
    assert got == rc, stderr
    assert "combos verifier-accepted" in stdout
    assert ("FAIL" in stdout) == bool(rc)
    assert report is not None
