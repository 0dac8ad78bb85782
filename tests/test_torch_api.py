"""The port's REST API (``runtime/api.py``) against the JAX package's, on
the CPU: the nine tests of ``test_api.py`` sent as the same requests to
both packages' ``APIServer`` over their unix sockets, each answer held
equal to the reference's. The keys that differ by design are named where
they are dropped:

- ``overload`` and ``resources`` (at any depth): the overload
  controller's state and the pressure ledger's summary, which appear
  once their controllers' first intervals have run and carry clocks and
  samples of their own — the timing of each process, not a property of
  the package;
- ``trace``: the span tracer's stats; the tracer is process-global, and
  other test files on the same worker reconfigure it (its capacity);
- status's ``Tracing:`` line in the CLI's text output, which prints the
  ``trace`` document;
- ``fused_kernels``: each datapath's kernel selector (the JAX engine's
  Pallas selector, the port's CUDA one, which adds each kernel's launch
  count to the reference's three keys); equal on the fakes (``None``)
  and stated for both on the real datapaths;
- ``ciliumtpu_classify_fn_cache_*`` metric lines: the JAX classify memo,
  which the port does not have; and ``ciliumtpu_trace_*``, which a fresh
  engine exports once the process-global tracer has dropped spans.

Flows are classified at one shared ``now`` taken when the test starts,
with TCP ACK (an established lifetime), so the engines' CT GC
controllers, which sweep at the wall clock, leave them alone however
long the test waits in a worker's queue.

Beyond the mirrors: ``/v1/classify`` and ``/v1/status`` on
``TorchDatapath`` against ``JITDatapath``, and the verifier budget that
``note_verifier_budget`` attaches.
"""

import importlib
import json
import os
import subprocess
import sys
import time

import pytest

from cilium_tpu.utils import constants as C
from tests.test_torch_datapath import SIDES, bare_engine, mods, rec, rich_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = {"jax": "cilium_tpu", "torch": "cilium_tpu_torch"}
#: the keys dropped from every compared document (module docstring)
TIMING = {"overload", "resources", "trace"}
#: the bound on a REST classify: the first request of a new bucket shape
#: compiles (XLA) on the JAX side, which on a loaded test machine takes
#: longer than the 10 s default
REQUEST_TIMEOUT_S = 120.0
#: the port's ``fused_state`` launch counts on the CPU: no kernel launches
ZERO_LAUNCHES = {"lpm_lookup_fused": 0, "ct_probe_pair_fused": 0,
                 "policy_verdict_fused": 0}


def api(side):
    return importlib.import_module(f"{PKG[side]}.runtime.api")


def fake_live_engine(side, sock, now):
    """``test_api.py``'s ``live_engine`` on ``side``'s package."""
    m = mods(side)
    cfg = m.config.DaemonConfig(ct_capacity=1024, auto_regen=False,
                                api_socket=sock, flowlog_mode="all",
                                device="cpu") if side == "torch" else \
        m.config.DaemonConfig(ct_capacity=1024, auto_regen=False,
                              api_socket=sock, flowlog_mode="all")
    eng = m.engine.Engine(cfg, datapath=m.datapath.FakeDatapath(
        m.config.DaemonConfig(ct_capacity=1024)))
    eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",), ep_id=1)
    eng.add_endpoint(["k8s:role=fe"], ips=("192.168.1.30",), ep_id=3)
    eng.apply_policy([{
        "endpointSelector": {"matchLabels": {"app": "web"}},
        "ingress": [{"fromEndpoints": [{"matchLabels": {"role": "fe"}}],
                     "toPorts": [{"ports": [
                         {"port": "443", "protocol": "TCP"}]}]}]}])
    eng.regenerate()
    batch = importlib.import_module(
        f"{PKG[side]}.kernels.records").batch_from_records(
        [rec("192.168.1.30", "192.168.1.10", 40000, 443, C.TCP_ACK),
         rec("192.168.1.30", "192.168.1.10", 40001, 80, C.TCP_ACK)],
        eng.active.snapshot.ep_slot_of)
    eng.classify(batch, now=now)
    eng.start_background()
    return eng


@pytest.fixture
def live(tmp_path):
    """Both packages' fake-datapath engines, each serving its socket, and
    the time their flows were classified at. → {side: (engine, client),
    "now": now}"""
    engines = {"now": int(time.time())}
    for side in SIDES:
        sock = str(tmp_path / f"{side}.sock")
        engines[side] = (fake_live_engine(side, sock, engines["now"]),
                         api(side).UnixAPIClient(sock))
    yield engines
    for side in SIDES:
        engines[side][0].stop()


def ask(live, method, path, body=None):
    """The same request to both servers. → ((code_j, doc_j),
    (code_t, doc_t))"""
    return tuple(live[s][1].request(method, path, body) for s in SIDES)


def untimed(doc):
    """``doc`` without the ``TIMING`` keys at any depth."""
    if isinstance(doc, dict):
        return {k: untimed(v) for k, v in doc.items() if k not in TIMING}
    if isinstance(doc, list):
        return [untimed(v) for v in doc]
    return doc


def same(live, method, path, body=None):
    """The same request to both servers, the answers held equal apart
    from the ``TIMING`` keys. → the port's (code, doc)."""
    (cj, dj), (ct, dt) = ask(live, method, path, body)
    assert cj == ct, (path, dj, dt)
    assert untimed(dj) == untimed(dt), path
    return ct, dt


class TestAPIServer:
    def test_healthz_and_status(self, live):
        code, doc = same(live, "GET", "/v1/healthz")
        assert code == 200 and doc["status"] == "ok"
        code, st = same(live, "GET", "/v1/status")
        assert code == 200
        assert st["endpoints"] == 2 and st["rules"] == 1
        assert st["conntrack"]["live"] >= 1

    def test_endpoints_and_identities(self, live):
        code, eps = same(live, "GET", "/v1/endpoints")
        assert code == 200 and [e["ep_id"] for e in eps] == [1, 3]
        code, one = same(live, "GET", "/v1/endpoints/1")
        assert code == 200 and one["ingress"]["enforced"]
        code, _ = same(live, "GET", "/v1/endpoints/99")
        assert code == 404
        code, ids = same(live, "GET", "/v1/identities")
        assert code == 200 and len(ids) > 2

    def test_policy_roundtrip_and_trace(self, live):
        code, rules = same(live, "GET", "/v1/policy")
        assert code == 200 and len(rules) == 1
        code, doc = same(live, "POST", "/v1/policy", [{
            "endpointSelector": {"matchLabels": {"app": "web"}},
            "ingress": [{"toPorts": [{"ports": [
                {"port": "80", "protocol": "TCP"}]}]}]}])
        assert code == 200 and doc["revision"] > 1
        for dport, verdict in ((80, "ALLOWED"), (22, "DENIED")):
            code, tr = same(live, "POST", "/v1/policy/trace", {
                "ep": 1, "direction": "ingress", "remote": "192.168.1.30",
                "dport": dport, "proto": "TCP"})
            assert code == 200 and tr["verdict"] == verdict

    def test_ct_flows_metrics(self, live):
        code, ct = same(live, "GET", f"/v1/ct?limit=8&now={live['now']}")
        assert code == 200 and len(ct) >= 1
        assert ct[0]["dport"] == 443
        code, flows = same(live, "GET", "/v1/flows?last=10")
        assert code == 200 and len(flows) == 2
        (cj, tj), (ct_, tt) = ask(live, "GET", "/v1/metrics")
        assert cj == ct_ == 200 and "policy_revision" in tt

        def names(text):
            return {ln.split(" ")[0].split("{")[0]
                    for ln in text.splitlines()
                    if ln and not ln.startswith("#")
                    and "classify_fn_cache" not in ln
                    and not ln.startswith("ciliumtpu_trace_")}
        assert names(tj) == names(tt)

    def test_config_patch_enforcement(self, live):
        (cj, dj), (ct, dt) = ask(live, "GET", "/v1/config")
        assert cj == ct == 200 and dt["enforcement_mode"] == "default"
        assert set(dj) - set(dt) == set() and dt["device"] == "cpu"
        code, _ = same(live, "PATCH", "/v1/config",
                       {"enforcement_mode": "never"})
        assert code == 200
        assert live["torch"][0].ctx.enforcement_mode == "never"
        code, tr = same(live, "POST", "/v1/policy/trace", {
            "ep": 1, "direction": "ingress", "remote": "192.168.1.30",
            "dport": 22})
        assert tr["verdict"] == "ALLOWED"
        code, _ = same(live, "PATCH", "/v1/config",
                       {"enforcement_mode": "bogus"})
        assert code == 400
        code, _ = same(live, "PATCH", "/v1/config", {"batch_size": 1})
        assert code == 400

    def test_health_probe_route(self, live):
        code, doc = same(live, "GET", "/v1/health")
        assert code == 200
        assert set(doc) == {"1", "3", "engine"}
        assert doc["engine"]["state"] == C.HEALTH_OK

    def test_stale_socket_is_replaced(self, live, tmp_path):
        eng, _ = live["torch"]
        sock = eng.config.api_socket
        eng.stop()
        assert not os.path.exists(sock)
        with open(sock, "w") as f:
            f.write("stale")
        m = mods("torch")
        cfg = m.config.DaemonConfig(ct_capacity=1024, auto_regen=False,
                                    api_socket=sock, device="cpu")
        eng2 = m.engine.Engine(cfg, datapath=m.datapath.FakeDatapath(cfg))
        eng2.start_background()
        try:
            code, _ = api("torch").UnixAPIClient(sock).get("/v1/healthz")
            assert code == 200
        finally:
            eng2.stop()


def run_cli(side, argv):
    return subprocess.run(
        [sys.executable, "-m", f"{PKG[side]}.cli.main"] + argv,
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})


#: the lines of a CLI's text output that print a ``TIMING`` key: status's
#: ``Tracing:`` line is the ``trace`` document (the process-global span
#: tracer's stats), printed once a tracer in the serving process is on
TIMED_LINES = ("Tracing:",)


def cli_untimed(stdout):
    """A CLI's text output without its ``TIMED_LINES``."""
    return "".join(line for line in stdout.splitlines(keepends=True)
                   if not line.startswith(TIMED_LINES))


class TestCLILive:
    def test_cli_live_commands(self, live):
        """Each live command of ``test_api.py`` through both CLIs against
        their own servers: the same exit codes and output."""
        socks = {s: live[s][0].config.api_socket for s in SIDES}
        for words, rest in ((["status"], []),
                            (["endpoint", "list"], ["-o", "json"]),
                            (["policy", "trace"],
                             ["--ep", "1", "--direction", "ingress",
                              "--remote", "192.168.1.30", "--dport", "443"]),
                            (["ct", "list"], ["--now", str(live["now"])]),
                            (["monitor"], ["-o", "json"])):
            argv = words + rest
            outs = {s: run_cli(s, words + ["--api", socks[s]] + rest)
                    for s in SIDES}
            assert outs["jax"].returncode == outs["torch"].returncode == 0, \
                (argv, outs["torch"].stderr)
            assert cli_untimed(outs["jax"].stdout) == \
                cli_untimed(outs["torch"].stdout), argv
        out = run_cli("torch", ["metrics", "--api", socks["torch"]])
        assert out.returncode == 0 and "policy_revision" in out.stdout
        assert "Endpoints:        2" in run_cli(
            "torch", ["status", "--api", socks["torch"]]).stdout

    def test_status_prints_the_process_tracer(self, live):
        """The field that differed under load: an earlier test on the same
        worker that leaves the JAX package's process-global ``TRACER`` on
        (``test_fused.py``'s ``trace_sample_rate=1.0`` engine) makes the
        JAX server's ``status`` print a ``Tracing:`` line the port's
        server does not. Only that line differs."""
        from cilium_tpu.observe.trace import TRACER
        socks = {s: live[s][0].config.api_socket for s in SIDES}
        TRACER.configure(sample_rate=1.0)
        try:
            outs = {s: run_cli(s, ["status", "--api", socks[s]]).stdout
                    for s in SIDES}
        finally:
            TRACER.configure(sample_rate=0.0)
            TRACER.reset()
        assert outs["jax"] != outs["torch"]
        diff = set(outs["jax"].splitlines()) ^ set(outs["torch"].splitlines())
        assert [line.split()[0] for line in diff] == ["Tracing:"], diff
        assert cli_untimed(outs["jax"]) == cli_untimed(outs["torch"])

    def test_cli_requires_a_source(self):
        for side in SIDES:
            out = run_cli(side, ["status"])
            assert out.returncode != 0


# --------------------------------------------------------------------------- #
# the serving routes on the real datapaths
# --------------------------------------------------------------------------- #
def test_classify_route_on_torch_datapath_equals_jax(tmp_path):
    """``POST /v1/classify`` through the pipeline of the port's engine on
    ``TorchDatapath`` answers as the JAX engine on ``JITDatapath`` does,
    record for record, and ``/v1/status`` agrees but for the kernel
    selector, whose mode each side states."""
    docs = {}
    engines = {}
    now = int(time.time())
    for side in SIDES:
        sock = str(tmp_path / f"{side}.sock")
        eng = rich_world(bare_engine(
            side, api_socket=sock,
            pipeline_request_timeout_s=REQUEST_TIMEOUT_S), "lb")
        eng.start_background()
        engines[side] = eng
        client = api(side).UnixAPIClient(sock,
                                         timeout=REQUEST_TIMEOUT_S + 60)
        records = []
        for sp in range(40000, 40006):
            records.append({"src": "192.168.1.10", "dst": "172.30.0.1",
                            "sport": sp, "dport": 443, "ep": 1,
                            "direction": "egress", "flags": C.TCP_ACK})
            records.append({"src": f"172.16.{sp % 6}.5",
                            "dst": "192.168.1.10", "sport": sp,
                            "dport": 80 + (sp % 2) * 363, "ep": 1,
                            "direction": "ingress", "flags": C.TCP_ACK})
        code, doc = client.post("/v1/classify",
                                {"records": records, "now": now})
        assert code == 200, doc
        code2, again = client.post("/v1/classify", {
            "records": records, "now": now + 1})
        assert code2 == 200
        st = client.get("/v1/status")[1]
        docs[side] = (doc, again, st)
    assert docs["jax"][0] == docs["torch"][0]
    assert docs["jax"][1] == docs["torch"][1]
    assert {v["ct_state"] for v in docs["torch"][1]["verdicts"]} \
        >= {"ESTABLISHED"}
    sj, st = docs["jax"][2], docs["torch"][2]
    assert sj["fused_kernels"] == {"mode": "off", "active": False,
                                   "interpret": False}
    assert st["fused_kernels"] == {"mode": "auto", "active": False,
                                   "interpret": False,
                                   "launches": ZERO_LAUNCHES}
    for k in ("revision", "endpoints", "rules", "services", "conntrack"):
        assert sj[k] == st[k], k
    for eng in engines.values():
        eng.stop()


def test_status_cites_the_verifier_budget(tmp_path):
    """``note_verifier_budget`` with the port's ``budget_doc``: ``/v1/
    status`` carries it under ``hbm.verifier``."""
    from cilium_tpu_torch.compile.verifier import ComboReport, budget_doc
    sock = str(tmp_path / "t.sock")
    eng = bare_engine("torch", api_socket=sock)
    doc = budget_doc([ComboReport("dual+dict", True, argument_bytes=10,
                                  temp_bytes=5)], max_hbm_bytes=100)
    eng.note_verifier_budget(doc)
    eng.start_background()
    try:
        code, st = api("torch").UnixAPIClient(sock).get("/v1/status")
        assert code == 200
        assert st["hbm"]["verifier"] == json.loads(json.dumps(doc))
        assert st["hbm"]["verifier"]["worst_total_bytes"] == 15
    finally:
        eng.stop()
