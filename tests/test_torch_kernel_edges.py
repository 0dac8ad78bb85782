"""The plain versions that the card holds kernels K1, K2 and K3 against
(``lpm_lookup_plain``, ``ct_probe_pair_plain``, ``policy_verdict_plain``),
and K1's derived tables and walk (``lpm_derive``, ``lpm_walk_derived``),
against the JAX package on the inputs where a kernel's design could go
wrong (``cilium_tpu_torch/kernels/edge_cases.py``): prefix lengths around
every byte boundary, shared cells, misses at every depth, single-child
runs, tries whose dead node is not inert, mixed-family warps; wrapping
probe runs,
expiries at the clock's edges, duplicate and dead copies, probe depths 1
and 8, high key words; L7 prefix lengths around every 16-byte boundary,
method ANY, set-id clamping, tokens, rule validity and out-of-range rows.
The JAX side runs its jnp core and its Pallas kernel in interpret mode.
Exact equality."""

import numpy as np
import pytest

import jax.numpy as jnp

import torch

from cilium_tpu.kernels import conntrack as jct
from cilium_tpu.kernels import fused as jfk
from cilium_tpu.kernels.classify import classify_interior_core as jax_interior
from cilium_tpu.kernels.lpm import lpm_walk_prov_core as jax_lpm
from cilium_tpu.utils import constants as JC

from cilium_tpu_torch.kernels import fused as tfk
from cilium_tpu_torch.kernels.edge_cases import (PATH_LENS, edge_cases,
                                                 lpm_args, policy_args,
                                                 probe_args)
from cilium_tpu_torch.kernels.lpm import (MAX_RUN, RUN_K_BITS, lpm_derive,
                                          lpm_walk_derived)
from cilium_tpu_torch.world import make_world

PROBE, POLICY, LPM = edge_cases(seed=0)


def _eq(want, got, what):
    w = np.asarray(want)
    g = got.numpy()
    assert g.dtype == w.dtype, f"{what}: {g.dtype} != {w.dtype}"
    np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.parametrize("name", sorted(PROBE))
def test_probe_pair_edge_case(name):
    case = PROBE[name]
    ct_j = {k: jnp.asarray(v) for k, v in case.ct.items()}
    fwd_j, rev_j = jnp.asarray(case.fwd), jnp.asarray(case.rev)
    now = jnp.uint32(case.now)
    want = [jct.ct_probe_core(ct_j["keys"], ct_j["expiry"], k, now,
                              case.depth) for k in (fwd_j, rev_j)]
    pallas = jfk.ct_probe_pair_fused(ct_j, fwd_j, rev_j, now,
                                     probe_depth=case.depth, interpret=True)
    args = probe_args(case, "cpu")
    for got in (tfk.ct_probe_pair_plain(*args),
                tfk.ct_probe_pair_fused(*args)):
        for side, w, p, g in zip(("fwd", "rev"), want, pallas, got):
            _eq(w, g, f"{name} {side}")
            _eq(p, g, f"{name} {side} (pallas)")
    slots = np.asarray(want[0])
    if name == "full_run_no_match":
        assert (slots == -1).all()
    else:
        assert (slots >= 0).any() and (slots == -1).any()
    if name == "wrap":              # every run starts in the last 3 slots
        assert ((slots >= 0) & (slots < 8)).any()


@pytest.mark.parametrize("name", sorted(POLICY))
def test_policy_verdict_edge_case(name):
    case = POLICY[name]
    tj = {k: jnp.asarray(v) for k, v in case.tensors.items()}
    rows_j = tuple(jnp.asarray(r) for r in case.rows)
    want = jax_interior(tj, *rows_j)
    pallas = jfk.policy_verdict_fused(tj, *rows_j, interpret=True)
    args = policy_args(case, "cpu")
    names = ("allow", "reason", "status", "redirect", "matched_rule")
    for got in (tfk.policy_verdict_plain(*args),
                tfk.policy_verdict_fused(*args)):
        for col, w, p, g in zip(names, want, pallas, got):
            _eq(w, g, f"{name} {col}")
            _eq(p, g, f"{name} {col} (pallas)")
    reason = np.asarray(want[1])
    assert np.asarray(want[3]).any(), "no REDIRECT row"
    l7_drops = reason == int(JC.DropReason.POLICY_L7)
    if name.startswith("path_len_"):
        # endpoint 0 redirects every row to set 1, whose one rule has
        # this prefix length: a length <= 0 matches every path
        plen = int(name.rsplit("_", 1)[1])
        on_set_1 = case.rows[0] == 0
        assert l7_drops[on_set_1].any() == (plen > 0)
    else:
        assert l7_drops.any()


def test_cases_cover_every_listed_prefix_length():
    assert {f"path_len_{p}" for p in PATH_LENS} <= set(POLICY)
    assert len(PROBE) + len(POLICY) >= 14


@pytest.mark.parametrize("name", sorted(LPM))
def test_lpm_edge_case(name):
    case = LPM[name]
    v4n, v6n = jnp.asarray(case.v4_nodes), jnp.asarray(case.v6_nodes)
    addr, is_v6 = jnp.asarray(case.addr), jnp.asarray(case.is_v6)
    want = jax_lpm(v4n, v6n, addr, is_v6, case.default_index,
                   v4_only=case.v4_only)
    refs = [want]
    if case.addr.shape[0]:          # the Pallas grid needs a row
        refs.append(jfk.lpm_lookup_fused(
            v4n, None if case.v4_only else v6n, addr,
            None if case.v4_only else is_v6, case.default_index,
            v4_only=case.v4_only, interpret=True))
    args = lpm_args(case, "cpu")
    d4, d6 = lpm_derive(args[0]), lpm_derive(args[1])
    # a v4-only launch reads no family bit: every row walks the v4 tables
    flags = torch.zeros_like(args[3]) if case.v4_only else args[3]
    derived = lpm_walk_derived(d4, d6, args[2], flags, case.default_index)
    for got, how in ((tfk.lpm_lookup_plain(*args), "plain"),
                     (tfk.lpm_lookup_fused(*args), "wrapper"),
                     (derived[:2], "derived walk")):
        for ref in refs:
            _eq(ref[0], got[0], f"{name} idx ({how})")
            _eq(ref[1], got[1], f"{name} provenance ({how})")
    idx, meta = np.asarray(want[0]), np.asarray(want[1])
    steps = derived[2].numpy()
    levels = np.where(case.is_v6 & (not case.v4_only), 16, 4)
    assert (steps >= 1).all() and (steps <= levels).all()
    keeps_dead = not name.startswith("dead_node")
    for d in (d4, d6):
        child, run = d.cells[..., 0], d.cells[..., 3]
        # a trie that breaks the dead-node invariant gets no ends and no
        # runs: its walk is the reference's, level for level
        assert bool((child < 0).any()) == keeps_dead
        assert keeps_dead or bool((run < 0).all())
    if not keeps_dead:
        assert (steps == levels).all()
        if name == "dead_node_values":
            assert (idx == 9).any()
    elif name.startswith("run_"):
        runs = d6.cells[..., 3]
        assert bool((runs >= 0).any())
        assert (steps[case.is_v6] < 16).all()
        if name == "run_past_last_level":
            assert int((runs & ((1 << RUN_K_BITS) - 1)).max()) >= 8
    if name == "misses_at_levels":
        assert (meta == -1).any() and (meta >= 0).any()
        # dies at the root, in the run past it, and at the last level
        assert set(steps[~case.is_v6]) >= {1, 2, 3}
        assert 16 in set(steps[case.is_v6]) or (meta[case.is_v6] == -1).any()
    if name.endswith("_lengths"):
        plens = {int(m) & 0xFF for m in meta if m >= 0}
        assert len(plens) >= 5
    assert (idx[meta == -1] == case.default_index).all()


def test_lpm_cases_cover_the_listed_inputs():
    mixed = LPM["warps_mix_families_n300"]
    assert mixed.addr.shape[0] % 256 and mixed.is_v6[:32].any() \
        and (~mixed.is_v6[:32]).any()
    assert LPM["v4_only_with_v6_rows"].is_v6.any()
    assert {LPM[n].addr.shape[0] for n in ("n_0", "n_1")} == {0, 1}
    # misses resolve to a default index other than 0 in most cases
    assert sum(c.default_index != 0 and (c.addr.shape[0] > 1)
               for c in LPM.values()) >= 12
    assert len(LPM) >= 16


def test_lpm_derived_cache_follows_in_place_edits():
    """The wrapper's derived tables are built once per trie, served again
    while the trie is unchanged, and rebuilt after an in-place edit."""
    case = LPM["misses_at_levels"]
    v4, v6, addr, is_v6, default, _ = lpm_args(case, "cpu")
    first = tfk.lpm_derived(v4)
    assert tfk.lpm_derived(v4) is first
    hit = torch.tensor([[0, 0, 0xFFFF, (11 << 24) | 0x010203]],
                       dtype=torch.int64).to(torch.int32)
    d6, v4_row = tfk.lpm_derived(v6), torch.zeros(1, dtype=torch.bool)
    before = lpm_walk_derived(first, d6, hit, v4_row, default)[0]
    assert int(before[0]) == default
    v4[0, 11, 1] = 42                       # 11.0.0.0/8 now names index 42
    again = tfk.lpm_derived(v4)
    assert again is not first
    assert tfk.lpm_derived(v4) is again
    got = lpm_walk_derived(again, d6, hit, v4_row, default)
    want = jax_lpm(jnp.asarray(v4.numpy()), None,
                   jnp.asarray(hit.numpy().view(np.uint32)), None, default,
                   v4_only=True)
    assert int(got[0][0]) == 42
    _eq(want[0], got[0], "after the edit")
    del v4, first, again
    assert not [k for k in tfk._DERIVED if k[1] == tuple(case.v4_nodes.shape)
                and tfk._DERIVED[k][0]() is None]


def test_lpm_derived_cache_sees_only_versioned_edits():
    """The cache's contract (``fused.lpm_derived``): a trie is edited by a
    torch in-place op on the tensor itself. A write through ``.data``
    leaves ``_version`` as it was, so the tables of the trie as it was
    are served on; the next in-place op rebuilds them with both writes."""
    v4 = lpm_args(LPM["misses_at_levels"], "cpu")[0]
    first = tfk.lpm_derived(v4)
    version = v4._version
    v4.data[0, 11, 1] = 42
    assert v4._version == version
    assert tfk.lpm_derived(v4) is first
    assert int(first.cells[0, 11, 1]) != 42
    v4[0, 12, 1] = 43
    again = tfk.lpm_derived(v4)
    assert again is not first
    assert [int(again.cells[0, b, 1]) for b in (11, 12)] == [42, 43]


@pytest.mark.parametrize("shape, dtype", [((3, 128, 3), torch.int32),
                                          ((3, 256, 3), torch.int64),
                                          ((256, 3), torch.int32)])
def test_lpm_derive_refuses_a_malformed_trie(shape, dtype):
    """The kernel indexes the derived cells as [n, 256]: a trie of
    another shape or dtype is refused where its tables are built."""
    with pytest.raises(ValueError, match=r"\[n, 256, 3\] int32"):
        lpm_derive(torch.zeros(shape, dtype=dtype))


@pytest.mark.parametrize("config", ["cfg5", "mixed"])
def test_lpm_derived_walk_on_world(config):
    """The derived walk equals the JAX walk on a world's tries and every
    row of its batch, and shortens the chain: at most 4 dependent loads a
    row where the reference walks 16 levels for v6."""
    w = make_world(config, seed=1, device="cpu", preset="smoke")
    from cilium_tpu_torch.kernels.records import unpack_wire, wire_to_torch
    b = unpack_wire(wire_to_torch(w.pack(w.next_batch()), "cpu"))
    addr = torch.where((b["direction"] == 0)[:, None], b["dst"], b["src"])
    v4, v6 = w.tensors["lpm_v4"], w.tensors["lpm_v6"]
    flags = torch.zeros_like(b["is_v6"]) if w.v4_only else b["is_v6"]
    got = lpm_walk_derived(lpm_derive(v4), lpm_derive(v6), addr, flags,
                           w.world_index)
    want = jax_lpm(jnp.asarray(v4.numpy()), jnp.asarray(v6.numpy()),
                   jnp.asarray(addr.numpy().view(np.uint32)),
                   jnp.asarray(b["is_v6"].numpy()), w.world_index,
                   v4_only=w.v4_only)
    _eq(want[0], got[0], f"{config} idx")
    _eq(want[1], got[1], f"{config} provenance")
    assert int(got[2].max()) <= 4 < MAX_RUN
