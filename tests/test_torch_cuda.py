"""The port's CUDA kernels on the card against their plain torch versions,
at test size (the smoke presets of both worlds). Marked ``cuda`` and
skipped without a CUDA device; on a machine with one::

    python -m pytest --noconftest tests/test_torch_cuda.py -q

``--noconftest`` because the suite's conftest imports JAX, which the
port's machine need not have. ``chip_smoke.py`` runs the same checks at
full width. The edge cases of ``kernels/edge_cases.py`` run here as they
do in ``chip_smoke.py``.
"""

import pytest
import torch

from cilium_tpu_torch.kernels import fused as fk
from cilium_tpu_torch.kernels.classify import make_classify_fn
from cilium_tpu_torch.kernels.edge_cases import (edge_cases, lpm_args,
                                                 policy_args, probe_args)
from cilium_tpu_torch.kernels.records import unpack_wire, wire_to_torch
from cilium_tpu_torch.world import make_world

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return "cuda"


def _batch(world):
    return unpack_wire(wire_to_torch(world.pack(world.next_batch()),
                                     "cuda"))


@pytest.mark.parametrize("config", ["cfg5", "mixed"])
def test_kernels_match_plain_versions(device, config):
    world = make_world(config, seed=2, device=device, preset="smoke")
    b = _batch(world)
    remote = torch.where((b["direction"] == 0)[:, None], b["dst"], b["src"])
    largs = (world.tensors["lpm_v4"], world.tensors["lpm_v6"], remote,
             b["is_v6"], world.world_index, world.v4_only)
    for g, w in zip(fk.lpm_lookup_fused(*largs), fk.lpm_lookup_plain(*largs)):
        assert torch.equal(g, w)
    idx = fk.lpm_lookup_plain(*largs)[0]
    est = torch.arange(idx.shape[0], device=device) % 3 == 0
    reply = torch.arange(idx.shape[0], device=device) % 5 == 1
    rows = (b["ep_slot"], b["direction"], idx, b["proto"], b["dport"],
            b["http_method"], b["http_path"], est, reply & ~est, b["valid"])
    for g, w in zip(fk.policy_verdict_fused(world.tensors, *rows),
                    fk.policy_verdict_plain(world.tensors, *rows)):
        assert torch.equal(g, w)
    fn = make_classify_fn(v4_only=world.v4_only, packed=True, fused=False,
                          device=device)
    fn(world.tensors, world.ct, world.pack(world.next_batch()), 1000,
       world.world_index)
    from cilium_tpu_torch.kernels.conntrack import ct_key_words_pair
    fwd, rev = ct_key_words_pair(b)
    for now in (1000, 1100):
        args = (world.ct, fwd, rev, now, 8)
        for g, w in zip(fk.ct_probe_pair_fused(*args),
                        fk.ct_probe_pair_plain(*args)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("config", ["cfg5", "mixed"])
def test_classify_kernel_path_matches_plain_path(device, config):
    world = make_world(config, seed=3, device=device, preset="smoke")
    fn = make_classify_fn(v4_only=world.v4_only, packed=True, device=device)
    fn_plain = make_classify_fn(v4_only=world.v4_only, packed=True,
                                fused=False, device=device)
    fk.reset_launches()
    for i in range(4):
        wire = world.pack(world.next_batch())
        ct_copy = {k: v.clone() for k, v in world.ct.items()}
        out_p, ct_p, cnt_p = fn_plain(world.tensors, ct_copy, wire, 1000 + i,
                                      world.world_index)
        out, ct, cnt = fn(world.tensors, world.ct, wire, 1000 + i,
                          world.world_index)
        for a, b in ((out_p, out), (cnt_p, cnt), (ct_p, ct)):
            for k in a:
                assert torch.equal(a[k], b[k]), (i, k)
    assert all(v == 4 for v in fk.LAUNCHES.values()), fk.LAUNCHES


def test_edge_cases_match_plain_versions(device):
    probe, policy, lpm = edge_cases(seed=0)
    for name, case in lpm.items():
        args = lpm_args(case, device)
        for g, w in zip(fk.lpm_lookup_fused(*args),
                        fk.lpm_lookup_plain(*args)):
            assert torch.equal(g, w), name
    for name, case in probe.items():
        args = probe_args(case, device)
        for g, w in zip(fk.ct_probe_pair_fused(*args),
                        fk.ct_probe_pair_plain(*args)):
            assert torch.equal(g, w), name
    for name, case in policy.items():
        args = policy_args(case, device)
        for g, w in zip(fk.policy_verdict_fused(*args),
                        fk.policy_verdict_plain(*args)):
            assert torch.equal(g, w), name


def test_wrappers_refuse_misaligned_inputs(device):
    """K2 reads key words as 8-byte pairs and K3 reads L7 prefixes 16
    bytes at a time; a view that breaks either alignment raises."""
    probe, policy, _lpm = edge_cases(seed=0)
    ct, fwd, rev, now, depth = probe_args(probe["wrap"], device)
    n = fwd.shape[0]
    shifted = torch.empty(n * 10 + 1, dtype=torch.int32,
                          device=device)[1:].view(n, 10)
    shifted.copy_(fwd)
    with pytest.raises(ValueError, match="aligned"):
        fk.ct_probe_pair_fused(ct, shifted, rev, now, depth)
    tensors, *rows = policy_args(policy["path_len_16"], device)
    path = tensors["l7_path"]
    moved = torch.empty(path.numel() + 4, dtype=torch.uint8,
                        device=device)[4:].view(path.shape)
    moved.copy_(path)
    with pytest.raises(ValueError, match="aligned"):
        fk.policy_verdict_fused({**tensors, "l7_path": moved}, *rows)


def test_lpm_derived_tables_follow_in_place_edits(device):
    """An in-place edit of a trie on the card rebuilds K1's derived
    tables: the kernel then sees the edit."""
    world = make_world("mixed", seed=4, device=device, preset="smoke")
    b = _batch(world)
    remote = torch.where((b["direction"] == 0)[:, None], b["dst"], b["src"])
    v4 = world.tensors["lpm_v4"].clone()
    largs = (v4, world.tensors["lpm_v6"], remote, b["is_v6"],
             world.world_index, False)
    fk.lpm_lookup_fused(*largs)
    first = fk.lpm_derived(v4)
    v4[0, :, 1] = 1                  # every v4 address now matches /8
    v4[0, :, 2] = 8
    assert fk.lpm_derived(v4) is not first
    for g, w in zip(fk.lpm_lookup_fused(*largs), fk.lpm_lookup_plain(*largs)):
        assert torch.equal(g, w)
