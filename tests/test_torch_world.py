"""The slice as a whole on the CPU: rules → the port's compiler → the
port's classify step, against rules → the JAX package's compiler → JAX's
classify step.

- The port's worlds (``make_world`` at the smoke preset) hold the host
  tensors the reference compiler makes from the same control plane, byte
  for byte: cfg5 and cfg3 against ``bench.build_config5`` /
  ``build_config3``, mixed against the mixed world of
  ``tests/test_torch_compile.py`` (cfg2 and cfg4 in one repository).
- cfg3, mixed and the LB world of ``tests/test_lb.py``: each side compiles
  its own snapshot and runs three batches of the same wire through its own
  packed classify step (the port's on CPU tensors, so its plain path) with
  the CT carried across; every out column, the counters and the seven CT
  arrays must be equal (exact). The LB world's batches take the LB stage.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
from cilium_tpu.compile.ct_layout import make_ct_arrays
from cilium_tpu.kernels.classify import classify_step as jax_step
from cilium_tpu.kernels.classify import make_classify_fn as jax_make_fn
from cilium_tpu.kernels.records import batch_from_records, pack_batch
from tests.test_lb import svc_packet
from tests.test_torch_compile import assert_tensors_equal, compiled
from tests.test_torch_datapath import reference_columns

from cilium_tpu_torch import convert
from cilium_tpu_torch.kernels.classify import classify_step, make_classify_fn
from cilium_tpu_torch.kernels.records import batch_to_torch
from cilium_tpu_torch.world import make_world


def reference_snapshot(name):
    if name == "cfg5":
        return bench.build_config5("smoke")[0]
    if name == "cfg3":
        return bench.build_config3("smoke")[0]
    return compiled("cilium_tpu", name)[0]


@pytest.fixture(scope="module")
def worlds():
    return {name: (make_world(name, seed=0, device="cpu", preset="smoke"),
                   reference_snapshot(name))
            for name in ("cfg5", "mixed", "cfg3")}


@pytest.fixture(scope="module")
def cfg5_bench():
    return bench.build_config5("smoke")


def _assert_world_is_compiled(world, snap):
    assert_tensors_equal(world.host_tensors, snap.tensors(), world.name)
    assert_tensors_equal(world.snapshot.tensors(), snap.tensors(),
                         world.name)
    assert world.snapshot.static_config() == snap.static_config()
    assert world.snapshot.nbytes == snap.nbytes
    assert world.world_index == snap.world_index
    assert world.ct["expiry"].shape == (snap.ct_config.capacity,)
    # placed as the port reads them: u16 image as int16, ids as int32
    assert world.tensors["verdict"].dtype == torch.int16
    assert world.tensors["identity_ids"].dtype == torch.int32
    for k, v in snap.tensors().items():
        assert tuple(world.tensors[k].shape) == v.shape, k
    assert world.declare_s > 0 and world.compile_s > 0


def test_cfg5_tensors_have_the_compiled_geometry(worlds, cfg5_bench):
    world, snap = worlds["cfg5"]
    _assert_world_is_compiled(world, snap)
    assert world.host_tensors["verdict"].shape == (1, 2, 502, 5007)
    assert world.v4_only == cfg5_bench[2]


@pytest.mark.parametrize("name", ["mixed", "cfg3"])
def test_world_tensors_equal_the_reference_compiler(worlds, name):
    world, snap = worlds[name]
    _assert_world_is_compiled(world, snap)


def test_cfg3_world_shape(worlds):
    world, snap = worlds["cfg3"]
    assert world.v4_only
    # 20,000 prefixes: a v4 trie past the cfg5 one, no v6 nodes, no LB
    assert world.host_tensors["lpm_v4"].shape[0] > 10000
    assert not any(k.startswith("lb_") for k in world.host_tensors)
    assert world.snapshot.image.enforced[0].tolist() == [True, False]


def test_cfg5_verdict_columns_agree_on_shared_churn_batches(cfg5_bench):
    snap, gen, v4_only = cfg5_bench
    world = make_world("cfg5", seed=0, device="cpu", preset="smoke")
    tj = {k: jnp.asarray(v) for k, v in snap.tensors().items()}
    ct_j = {k: jnp.asarray(v)
            for k, v in make_ct_arrays(snap.ct_config).items()}
    ct_t = world.ct
    rng = np.random.default_rng(0)
    for bi, now in enumerate((1000, 1001)):
        raw = gen(rng, 2048)
        out_j, ct_j, _ = jax_step(tj, ct_j,
                                  {k: jnp.asarray(v) for k, v in raw.items()},
                                  jnp.uint32(now),
                                  world_index=snap.world_index,
                                  v4_only=v4_only)
        out_t, ct_t, _ = classify_step(world.tensors, ct_t,
                                       batch_to_torch(raw, "cpu"), now,
                                       world.world_index, v4_only=v4_only,
                                       inplace=True)
        got = convert.to_numpy(out_t)
        for k in ("allow", "reason", "status"):
            np.testing.assert_array_equal(got[k], np.asarray(out_j[k]),
                                          err_msg=f"batch {bi}: {k}")
    # the second batch revisits flows of the first: established rows
    assert (got["status"] == 1).any()


# --------------------------------------------------------------------------- #
# compile → classify, both packages, every column
# --------------------------------------------------------------------------- #
def assert_same(want, got, what):
    assert sorted(want) == sorted(got), what
    for k in want:
        w = np.asarray(want[k])
        assert w.dtype == got[k].dtype, f"{what}:{k} dtype"
        np.testing.assert_array_equal(got[k], w, err_msg=f"{what}:{k}")


def run_both(snap_ref, tensors_np, world_index, cap, wires, v4_only):
    """JAX's packed step on the reference snapshot and the port's on its
    own compiled tensors, over the same wires with the CT carried across;
    → the reference's out columns per batch."""
    tj = {k: jnp.asarray(v) for k, v in snap_ref.tensors().items()}
    ct0 = make_ct_arrays(snap_ref.ct_config)
    assert ct0["expiry"].shape == (cap,)
    ct_j = {k: jnp.asarray(v) for k, v in ct0.items()}
    tt = convert.snapshot_tensors_to_torch(tensors_np, "cpu")
    ct_t = convert.ct_to_torch(ct0, "cpu")
    fn_j = jax_make_fn(v4_only=v4_only, donate_ct=False, packed=True)
    fn_t = make_classify_fn(v4_only=v4_only, packed=True, device="cpu")
    outs = []
    for bi, w in enumerate(wires):
        now = 1000 + 7 * bi
        w_j = tuple(jnp.asarray(x) for x in w) if isinstance(w, tuple) \
            else jnp.asarray(w)
        out_j, ct_j, cnt_j = fn_j(tj, ct_j, w_j, jnp.uint32(now),
                                  jnp.int32(snap_ref.world_index))
        out_t, ct_t, cnt_t = fn_t(tt, ct_t, w, now, world_index)
        out = {k: np.asarray(v) for k, v in out_j.items()}
        assert_same(out, reference_columns(convert.to_numpy(out_t)),
                    f"batch {bi} out")
        assert_same({k: np.asarray(v) for k, v in cnt_j.items()},
                    convert.to_numpy(cnt_t), f"batch {bi} counters")
        assert_same({k: np.asarray(v) for k, v in ct_j.items()},
                    convert.ct_to_numpy(ct_t), f"batch {bi} ct")
        outs.append(out)
    return outs


@pytest.mark.parametrize("name", ["cfg3", "mixed"])
def test_compiled_world_classifies_as_jax(worlds, name):
    world, snap = worlds[name]
    wires = [world.pack(world.next_batch()) for _ in range(3)]
    outs = run_both(snap, world.host_tensors, world.world_index,
                    world.ct["expiry"].shape[0], wires, world.v4_only)
    allow = np.concatenate([o["allow"] for o in outs])
    assert allow.any() and not allow.all()
    if name == "mixed":
        assert (outs[-1]["status"] == 1).any()
        assert np.concatenate([o["redirect"] for o in outs]).any()
        assert (np.concatenate([o["reason"] for o in outs]) == 180).any()


def test_lb_world_classifies_as_jax():
    snap_ref = compiled("cilium_tpu", "lb")[0]
    snap_port = compiled("cilium_tpu_torch", "lb")[0]
    rng = random.Random(4)
    wires, prior = [], []
    for _ in range(3):
        packets = [svc_packet(rng, rng.choice(
            ["172.20.0.10", "172.20.0.11", "172.20.0.12", "10.50.0.1",
             "8.8.8.8", "192.168.2.100"]), rng.choice([80, 8080, 30080]))
            for _ in range(56)] + prior[:8]
        prior = packets[:8]
        wires.append(pack_batch(batch_from_records(packets,
                                                   snap_ref.ep_slot_of)))
    outs = run_both(snap_ref, snap_port.tensors(), snap_port.world_index,
                    snap_port.ct_config.capacity, wires, False)
    svc = np.concatenate([o["svc"] for o in outs])
    assert svc.any() and not svc.all()           # the LB stage ran
    reasons = np.concatenate([o["reason"] for o in outs])
    assert (reasons == 0).any() and (reasons != 0).any()
