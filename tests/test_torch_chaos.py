"""The port's in-process chaos drill (``cilium-tpu-torch faults chaos``)
on the CPU, against the JAX package's drill.

The port's drill runs through its CLI entry point with ``--datapath
fake`` (the oracle-backed fake) and ``--datapath torch --device cpu``
(``TorchDatapath`` with the kernels' plain versions): each exits 0 with
every phase PASS, and its phases are the JAX drill's, in the same order
(regen storm and recovery, the clustermesh peer flap with a skewed
clock, the pipeline dispatch storm, the stall-storm watchdog restart,
the circuit breaker, CT survival across a restart, checkpoint
corruption, ``qos.enqueue`` fail-closed and the ``fqdn.parse``
fail-open dns-poison phase). The JAX drill runs on its fake datapath.
"""

import json

import pytest

from cilium_tpu_torch.cli.main import main as torch_main


@pytest.fixture(scope="module")
def jax_phases():
    """The JAX package's in-process drill on its fake datapath: its phase
    names in order (every one PASS)."""
    from cilium_tpu.cli.commands import _ChaosReport, _chaos_inprocess
    report = _ChaosReport()
    _chaos_inprocess(10, 7, "fake", report)
    assert report.ok, report.phases
    return [p["phase"] for p in report.phases]


@pytest.mark.parametrize("argv", [
    ["--datapath", "fake"],
    ["--datapath", "torch", "--device", "cpu"],
], ids=["fake", "torch-cpu"])
def test_in_process_drill_passes_every_jax_phase(argv, jax_phases, capsys):
    rc = torch_main(["faults", "chaos", "--seed", "7", "-o", "json",
                     *argv])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0 and doc["ok"], doc["phases"]
    assert [p["phase"] for p in doc["phases"]] == jax_phases
    assert all(p["ok"] for p in doc["phases"])
    # the torch datapath reports this process's kernel launches (none on
    # the CPU: the plain versions ran), the fake datapath has none
    if "torch" in argv:
        assert set(doc["launches"]) == {"lpm_lookup_fused",
                                        "ct_probe_pair_fused",
                                        "policy_verdict_fused",
                                        "flow_fingerprint_fused"}
    else:
        assert "launches" not in doc


def test_text_report_and_failure_exit(capsys, monkeypatch):
    """The text report prints a PASS line a phase and the verdict line;
    a failing phase makes the drill exit 1."""
    rc = torch_main(["faults", "chaos", "--datapath", "fake",
                     "--failures", "3"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("PASS ") == 10 and "chaos scenario PASSED" in out
    from cilium_tpu_torch.cli import commands

    def failing(failures, seed, kind, report, device="cuda"):
        report.record("regen-storm", False, "forced")
    monkeypatch.setattr(commands, "_chaos_inprocess", failing)
    rc = torch_main(["faults", "chaos", "--datapath", "fake"])
    out = capsys.readouterr().out
    assert rc == 1 and "FAIL regen-storm" in out
    assert "chaos scenario FAILED" in out


def test_fault_point_registry_equals_the_reference():
    """With QoS, the DNS plane and clustermesh imported, the port's fault
    injector knows exactly the reference's points (``qos.enqueue`` and
    ``fqdn.parse`` included): a chaos spec written for one package arms
    the same points in the other."""
    import cilium_tpu.fqdn  # noqa: F401
    import cilium_tpu.qos  # noqa: F401
    import cilium_tpu.runtime.clustermesh  # noqa: F401
    import cilium_tpu_torch.fqdn  # noqa: F401
    import cilium_tpu_torch.qos  # noqa: F401
    import cilium_tpu_torch.runtime.clustermesh  # noqa: F401
    from cilium_tpu.runtime.faults import FAULTS as JAX_FAULTS
    from cilium_tpu_torch.runtime.faults import FAULTS
    assert sorted(FAULTS.stats()) == sorted(JAX_FAULTS.stats())
    assert {"qos.enqueue", "fqdn.parse", "clustermesh.peer_read",
            "clustermesh.store_list"} <= set(FAULTS.stats())
