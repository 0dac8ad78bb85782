"""The port's CLI (``cli/``) against the JAX package's, on the CPU: the
twenty tests of ``test_cli.py``, each command run through both packages'
``main`` on one state dir (saved once by each package's engine: every
offline command reads both) and the exit codes and outputs held equal.
Dropped from a compared output: the metric lines of each package's
classify memo (``classify_fn_cache``, process-global), those of the
process-global tracer's drops (``ciliumtpu_trace_*``, present once other
tests on the worker made it drop), and the values of the measured-time
series (``*_seconds_sum``/``_max``).

Beyond the mirrors: ``faults chaos`` runs its in-process scenario, and
the inspection path loads no JAX, ``cilium_tpu`` or ``oracle``.
"""

import json
import os
import subprocess
import sys

import pytest

from cilium_tpu.cli.main import main as jax_main
from cilium_tpu.kernels.records import batch_from_records
from cilium_tpu.utils import constants as C
from cilium_tpu_torch.cli.main import main as torch_main
from tests.test_torch_checkpoint import ckpt
from tests.test_torch_datapath import SIDES, bare_engine, mods, rec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAINS = {"jax": jax_main, "torch": torch_main}

POLICY = [{
    "endpointSelector": {"matchLabels": {"app": "web"}},
    "egress": [{"toCIDR": ["10.0.0.0/8"],
                "toPorts": [{"ports": [{"port": "443", "protocol": "TCP"}]}]}],
    "egressDeny": [{"toCIDR": ["10.66.0.0/16"]}],
    "ingress": [{"toPorts": [{"ports": [{"port": "80", "protocol": "TCP"}],
                              "rules": {"http": [
                                  {"method": "GET", "path": "/api"}]}}]}],
}]


@pytest.fixture(scope="module", params=SIDES)
def state_dir(request, tmp_path_factory):
    """``test_cli.py``'s state dir, saved by one package's engine."""
    side = request.param
    d = tmp_path_factory.mktemp(f"state-{side}")
    svc = mods(side).services
    eng = bare_engine(side, ct_capacity=4096)
    eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",), ep_id=1)
    eng.apply_policy(POLICY)
    eng.upsert_service(svc.Service(
        name="api", namespace="prod",
        frontends=(svc.Frontend("172.30.0.1", 443, C.PROTO_TCP),),
        lb_backends=(svc.Backend("10.7.0.1", 443),)))
    eng.classify(batch_from_records(
        [rec("192.168.1.10", "10.1.2.3", 40000, 443,
             direction=C.DIR_EGRESS)],
        eng.active.snapshot.ep_slot_of), now=100)
    ckpt(side).save(eng, str(d))
    eng.stop()
    return str(d)


def memo_free(text):
    """``text`` without the classify-memo lines and the process-global
    tracer's drop counters (``ciliumtpu_trace_*``), and with the values
    of the measured-time series (``*_seconds_sum``/``*_seconds_max``,
    host timings of each process) blanked."""
    lines = []
    for ln in text.splitlines():
        if "classify_fn_cache" in ln or "ciliumtpu_trace_" in ln:
            continue
        name = ln.split(" ")[0]
        if name.endswith(("_seconds_sum", "_seconds_max")):
            ln = name
        lines.append(ln)
    return "\n".join(lines)


def run_cli(capsys, *argv):
    """``argv`` through both CLIs: equal exit codes and outputs.
    → the port's (rc, stdout)."""
    got = {}
    for side in SIDES:
        rc = MAINS[side](list(argv))
        got[side] = (rc, memo_free(capsys.readouterr().out))
    assert got["jax"] == got["torch"], argv
    return got["torch"]


def run_json(capsys, *argv):
    rc, out = run_cli(capsys, *argv, "-o", "json")
    assert rc == 0, out
    return json.loads(out)


class TestCLI:
    def test_version(self, capsys):
        rc, out = run_cli(capsys, "version")
        assert rc == 0 and "version" in out

    def test_status(self, state_dir, capsys):
        doc = run_json(capsys, "status", "--state-dir", state_dir)
        assert doc["endpoints"] == 1
        assert doc["services"] == 1
        assert doc["conntrack"]["live"] == 1

    def test_endpoint_list_get(self, state_dir, capsys):
        doc = run_json(capsys, "endpoint", "list", "--state-dir", state_dir)
        assert doc[0]["ep_id"] == 1 and "192.168.1.10" in doc[0]["ips"]
        doc = run_json(capsys, "endpoint", "get", "--state-dir", state_dir,
                       "1")
        assert doc["egress"]["enforced"] is True
        assert doc["egress"]["entries"] >= 2

    def test_identity_list(self, state_dir, capsys):
        doc = run_json(capsys, "identity", "list", "--state-dir", state_dir)
        ids = {e["id"] for e in doc}
        assert C.IDENTITY_WORLD in ids
        assert any(e["id"] >= C.CLUSTER_IDENTITY_BASE for e in doc)

    def test_policy_get(self, state_dir, capsys):
        doc = run_json(capsys, "policy", "get", "--state-dir", state_dir)
        assert doc == POLICY

    def test_policy_trace_allow(self, state_dir, capsys):
        doc = run_json(capsys, "policy", "trace", "--state-dir", state_dir,
                       "--ep", "1", "--remote", "10.1.2.3",
                       "--dport", "443", "--proto", "TCP")
        assert doc["verdict"] == "ALLOWED"
        assert doc["matched_key"] is not None
        assert doc["derived_from"]

    def test_policy_trace_deny_precedence(self, state_dir, capsys):
        doc = run_json(capsys, "policy", "trace", "--state-dir", state_dir,
                       "--ep", "1", "--remote", "10.66.1.1",
                       "--dport", "443")
        assert doc["verdict"] == "DENIED"
        assert doc["reason"] == "explicit deny rule"

    def test_policy_trace_default_deny(self, state_dir, capsys):
        doc = run_json(capsys, "policy", "trace", "--state-dir", state_dir,
                       "--ep", "1", "--remote", "8.8.8.8", "--dport", "22")
        assert doc["verdict"] == "DENIED"
        assert doc["matched_key"] is None

    def test_policy_trace_l7(self, state_dir, capsys):
        doc = run_json(capsys, "policy", "trace", "--state-dir", state_dir,
                       "--ep", "1", "--direction", "ingress",
                       "--remote", "8.8.8.8", "--dport", "80")
        assert doc["verdict"] == "ALLOWED"
        assert "L7" in doc["reason"]
        assert doc["l7_rules"]

    def test_service_list(self, state_dir, capsys):
        doc = run_json(capsys, "service", "list", "--state-dir", state_dir)
        assert doc[0]["name"] == "prod/api"
        assert any("172.30.0.1:443" in f for f in doc[0]["frontends"])

    def test_ct_list(self, state_dir, capsys):
        doc = run_json(capsys, "ct", "list", "--state-dir", state_dir,
                       "--now", "100")
        assert doc["live"] == 1
        e = doc["entries"][0]
        assert e["src"] == "192.168.1.10" and e["dst"] == "10.1.2.3"
        assert e["dport"] == 443 and e["proto"] == "TCP"

    def test_map_get(self, state_dir, capsys):
        doc = run_json(capsys, "map", "get", "--state-dir", state_dir,
                       "--ep", "1")
        actions = {e["action"] for e in doc}
        assert {"ALLOW", "DENY", "REDIRECT"} <= actions

    def test_text_output(self, state_dir, capsys):
        rc, out = run_cli(capsys, "policy", "trace", "--state-dir",
                          state_dir, "--ep", "1", "--remote", "10.66.1.1",
                          "--dport", "443")
        assert rc == 0 and "Final verdict: DENIED" in out

    def test_unknown_endpoint(self, state_dir, capsys):
        rc, _ = run_cli(capsys, "endpoint", "get", "--state-dir", state_dir,
                        "99")
        assert rc == 1


class TestObservability:
    @pytest.fixture()
    def obs_files(self, tmp_path):
        """Each package's engine writes its flow log and metrics file
        from the same two flows. → {side: (engine, dir)}"""
        got = {}
        for side in SIDES:
            d = tmp_path / side
            d.mkdir()
            eng = bare_engine(side, ct_capacity=4096, flowlog_mode="all",
                              flowlog_path=str(d / "flows.jsonl"),
                              metrics_path=str(d / "metrics.prom"))
            eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",),
                             ep_id=1)
            eng.apply_policy(POLICY)
            eng.regenerate()
            pkts = [rec("192.168.1.10", "10.1.2.3", 40000, 443,
                        direction=C.DIR_EGRESS),
                    rec("192.168.1.10", "10.1.2.4", 40001, 80,
                        direction=C.DIR_EGRESS)]
            eng.classify(batch_from_records(
                pkts, eng.active.snapshot.ep_slot_of), now=100)
            eng.flush_observability()
            got[side] = (eng, d)
        yield got
        for eng, _ in got.values():
            eng.stop()

    def _both(self, capsys, obs_files, *argv, name):
        """``argv`` (the command, then its path flag) with each package's
        file ``name`` through each CLI, and the port's CLI on the JAX
        engine's file: all equal."""
        outs = []
        for cli_side, file_side in (("jax", "jax"), ("torch", "torch"),
                                    ("torch", "jax")):
            path = str(obs_files[file_side][1] / name)
            rc = MAINS[cli_side]([argv[0], argv[1], path, *argv[2:]])
            outs.append((rc, memo_free(capsys.readouterr().out)))
        assert outs[0] == outs[1] == outs[2], argv
        return outs[1]

    def test_flowlog_sink_and_monitor(self, obs_files, capsys):
        for side in SIDES:
            path = obs_files[side][1] / "flows.jsonl"
            assert sum(1 for _ in open(path)) == 2
        rc, out = self._both(capsys, obs_files, "monitor", "--flowlog-path",
                             "-o", "json", name="flows.jsonl")
        lines = out.strip().splitlines()
        assert rc == 0 and len(lines) == 2
        recs = [json.loads(x) for x in lines]
        assert {r["verdict"] for r in recs} == {"FORWARDED", "DROPPED"}
        rc, out = self._both(capsys, obs_files, "monitor", "--flowlog-path",
                             "--verdict", "DROPPED", "-o", "json",
                             name="flows.jsonl")
        lines = out.strip().splitlines()
        assert len(lines) == 1 and json.loads(lines[0])["dst_port"] == 80
        rc, out = self._both(capsys, obs_files, "monitor", "--flowlog-path",
                             "--ip", "10.1.2.3", name="flows.jsonl")
        lines = out.strip().splitlines()
        assert len(lines) == 1 and "FORWARDED" in lines[0]

    def test_flowlog_ring_filters(self, obs_files):
        for side in SIDES:
            eng = obs_files[side][0]
            assert len(eng.flowlog.tail(verdict="DROPPED")) == 1
            assert len(eng.flowlog.tail(verdict="FORWARDED")) == 1

    def test_metrics_file_and_cli(self, obs_files, capsys):
        rc, out = self._both(capsys, obs_files, "metrics", "--metrics-path",
                             name="metrics.prom")
        assert rc == 0
        assert "ciliumtpu_packets_total 2" in out
        assert 'reason="POLICY"' in out

    def test_missing_files_error(self, capsys):
        rc, _ = run_cli(capsys, "monitor", "--flowlog-path", "/nope.jsonl")
        assert rc == 1
        rc, _ = run_cli(capsys, "metrics", "--metrics-path", "/nope.prom")
        assert rc == 1


class TestEnforcementModePersistence:
    @pytest.mark.parametrize("saver", SIDES)
    def test_trace_uses_checkpointed_enforcement(self, saver, tmp_path,
                                                 capsys):
        """'always' mode survives into both CLIs, whichever package
        saved it."""
        eng = bare_engine(saver, ct_capacity=4096, enforcement_mode="always")
        eng.add_endpoint(["k8s:app=lonely"], ips=("192.168.3.1",), ep_id=1)
        eng.active
        ckpt(saver).save(eng, str(tmp_path / "s"))
        eng.stop()
        doc = run_json(capsys, "policy", "trace", "--state-dir",
                       str(tmp_path / "s"), "--ep", "1",
                       "--remote", "8.8.8.8", "--dport", "443")
        assert doc["enforced"] is True
        assert doc["verdict"] == "DENIED"
        doc = run_json(capsys, "status", "--state-dir", str(tmp_path / "s"))
        assert doc["enforcement_mode"] == "always"


class TestTorchFree:
    def test_inspection_loads_no_jax_and_no_torch_device(self, state_dir):
        """The port's inspection path loads no JAX, ``cilium_tpu`` or
        ``oracle`` (all three poisoned in a subprocess)."""
        code = (
            "import sys\n"
            "for m in ('jax', 'cilium_tpu', 'oracle'):\n"
            "    sys.modules[m] = None\n"
            "from cilium_tpu_torch.cli.main import main\n"
            f"rc = main(['status', '--state-dir', {state_dir!r}])\n"
            "assert rc == 0\n"
            f"rc = main(['policy', 'trace', '--state-dir', {state_dir!r},"
            "'--ep', '1', '--remote', '10.1.2.3', '--dport', '443'])\n"
            "assert rc == 0\n"
            "print('PORT-OK')\n"
        )
        r = subprocess.run([sys.executable, "-c", code],
                           capture_output=True, text=True, timeout=120,
                           cwd=ROOT)
        assert "PORT-OK" in r.stdout, r.stdout + r.stderr


def test_faults_chaos_in_process_passes(capsys):
    """The in-process chaos scenario runs every phase in the port (on the
    oracle-backed fake here; ``test_torch_chaos.py`` runs both datapaths
    against the JAX drill): exit 0, every phase PASS."""
    rc = torch_main(["faults", "chaos", "--failures", "2", "--datapath",
                     "fake", "-o", "json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0 and doc["ok"]
    assert len(doc["phases"]) == 10
    assert all(p["ok"] for p in doc["phases"])
