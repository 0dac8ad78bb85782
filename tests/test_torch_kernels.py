"""The port's kernel stages against the JAX package's, case for case with
``tests/test_kernels.py``: the hash (host against device), the LPM walk
and the L7 match against the host references, the CT probe / insert /
apply / sweep mechanics, the key words, and the packers' ``out=`` variants.

Each case runs the reference's body once on each package: the JAX side on
``jax.numpy`` arrays through its jnp functions, as ``test_kernels.py``
runs them; the port on CPU tensors through its kernel stages (the LPM
through ``kernels.fused.lpm_lookup_fused``, whose CPU path is K1's plain
version). Each side asserts the reference's expectations, and the two
sides' results (hashes, identity indices, matches, slots, fail and claim
masks, the CT arrays after each step, the reclaimed counts, key words,
wires) are held equal, exactly, as numpy in the reference's dtypes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cilium_tpu.compile import ct_layout as j_ct_layout
from cilium_tpu.compile import l7 as j_l7
from cilium_tpu.compile import lpm as j_lpm
from cilium_tpu.kernels import conntrack as j_ctk
from cilium_tpu.kernels import hashing as j_hash
from cilium_tpu.kernels import records as j_records
from cilium_tpu.kernels.l7 import l7_match_batch
from cilium_tpu.kernels.lpm import lpm_lookup_batch
from cilium_tpu.model import rules as j_rules
from cilium_tpu.utils import constants as j_C
from cilium_tpu.utils import ip as j_ip
from cilium_tpu_torch.compile import ct_layout as t_ct_layout
from cilium_tpu_torch.compile import l7 as t_l7
from cilium_tpu_torch.compile import lpm as t_lpm
from cilium_tpu_torch.kernels import conntrack as t_ctk
from cilium_tpu_torch.kernels import fused as t_fused
from cilium_tpu_torch.kernels import hashing as t_hash
from cilium_tpu_torch.kernels import records as t_records
from cilium_tpu_torch.kernels.l7 import l7_match_core
from cilium_tpu_torch.model import rules as t_rules
from cilium_tpu_torch.utils import constants as t_C
from cilium_tpu_torch.utils import ip as t_ip


class JaxSide:
    """The JAX package's stages on ``jax.numpy`` arrays."""
    side = "jax"
    C, ip, records, rules = j_C, j_ip, j_records, j_rules
    ct_layout, l7, lpm = j_ct_layout, j_l7, j_lpm
    key_words_np = staticmethod(j_records.ct_key_words)

    @staticmethod
    def np(x):
        return np.asarray(x)

    @staticmethod
    def hash(words):
        return j_hash.hash_words_jnp(jnp.asarray(words))

    @staticmethod
    def lpm_walk(tables, addr_words, is_v6, default_index):
        return lpm_lookup_batch(jnp.asarray(tables.v4_nodes),
                                jnp.asarray(tables.v6_nodes),
                                jnp.asarray(addr_words), jnp.asarray(is_v6),
                                default_index=default_index)

    @staticmethod
    def l7_match(t, set_id, method, path):
        tensors = {"l7_methods": jnp.asarray(t.methods),
                   "l7_valid": jnp.asarray(t.valid),
                   "l7_path_len": jnp.asarray(t.path_len),
                   "l7_path": jnp.asarray(t.path)}
        return l7_match_batch(tensors, jnp.asarray(set_id, jnp.int32),
                              jnp.asarray(method, jnp.int32),
                              jnp.asarray(path))

    @staticmethod
    def ct(cap):
        return {k: jnp.asarray(v) for k, v in j_ct_layout.make_ct_arrays(
            j_ct_layout.CTConfig(capacity=cap)).items()}

    @staticmethod
    def batch(b):
        return {k: jnp.asarray(v) for k, v in b.items()}

    @staticmethod
    def keys(b, reverse=False):
        return j_ctk.ct_key_words_jnp(b, reverse=reverse)

    @staticmethod
    def probe(ct, keys, now):
        return j_ctk.ct_probe(ct, keys, jnp.uint32(now))

    @staticmethod
    def insert(ct, keys, want, now):
        return j_ctk.ct_insert_new(ct, keys, jnp.asarray(want),
                                   jnp.uint32(now))

    @staticmethod
    def apply(ct, b, slot, contrib, now, nk, ncr, zm):
        n = slot.shape[0]
        return j_ctk.ct_apply(ct, b, slot, jnp.zeros(n, bool),
                              jnp.asarray(contrib), jnp.uint32(now),
                              new_keys=nk, new_created=ncr, zero_mask=zm)

    @staticmethod
    def sweep(ct, now):
        return j_ctk.ct_sweep(ct, jnp.uint32(now))

    @staticmethod
    def ct_np(ct):
        return {k: np.asarray(v) for k, v in ct.items()}


class TorchSide:
    """The port's stages on CPU tensors."""
    side = "torch"
    C, ip, records, rules = t_C, t_ip, t_records, t_rules
    ct_layout, l7, lpm = t_ct_layout, t_l7, t_lpm
    key_words_np = staticmethod(t_records.ct_key_words_np)

    @staticmethod
    def np(x):
        return x.numpy()

    @staticmethod
    def hash(words):
        return t_hash.hash_words_u64(torch.as_tensor(
            np.asarray(words).view(np.int32)))

    @staticmethod
    def lpm_walk(tables, addr_words, is_v6, default_index):
        return t_fused.lpm_lookup_fused(
            torch.as_tensor(tables.v4_nodes), torch.as_tensor(tables.v6_nodes),
            torch.as_tensor(np.asarray(addr_words).view(np.int32)),
            torch.as_tensor(np.asarray(is_v6)), default_index)[0]

    @staticmethod
    def l7_match(t, set_id, method, path):
        tensors = {"l7_methods": torch.as_tensor(t.methods),
                   "l7_valid": torch.as_tensor(t.valid),
                   "l7_path_len": torch.as_tensor(t.path_len),
                   "l7_path": torch.as_tensor(t.path)}
        return l7_match_core(tensors,
                             torch.as_tensor(set_id, dtype=torch.int32),
                             torch.as_tensor(method, dtype=torch.int32),
                             torch.as_tensor(path))

    @staticmethod
    def ct(cap):
        return t_ct_layout.make_ct_arrays(t_ct_layout.CTConfig(capacity=cap),
                                          "cpu")

    @staticmethod
    def batch(b):
        return t_records.batch_to_torch(b, "cpu")

    @staticmethod
    def keys(b, reverse=False):
        return t_records.ct_key_words(b, reverse=reverse)

    @staticmethod
    def probe(ct, keys, now):
        return t_ctk.ct_probe(ct, keys, now)

    @staticmethod
    def insert(ct, keys, want, now):
        return t_ctk.ct_insert_new(ct, keys, torch.as_tensor(want), now)

    @staticmethod
    def apply(ct, b, slot, contrib, now, nk, ncr, zm):
        n = slot.shape[0]
        return t_ctk.ct_apply(ct, b, slot, torch.zeros(n, dtype=torch.bool),
                              torch.as_tensor(contrib), now,
                              new_keys=nk, new_created=ncr, zero_mask=zm)

    @staticmethod
    def sweep(ct, now):
        return t_ctk.ct_sweep(ct, now)

    @staticmethod
    def ct_np(ct):
        return {k: v.numpy().view(np.uint32) for k, v in ct.items()}


SIDES = (JaxSide, TorchSide)


def both(case):
    """Run ``case(K)`` on each package. → the port's observation, held
    equal to the reference's."""
    obs = [case(K) for K in SIDES]
    assert obs[0] == obs[1]
    return obs[1]


def u32(K, x):
    """A result as a list of the reference's uint32 values."""
    a = K.np(x)
    return (a.view(np.uint32) if a.dtype == np.int32 else a) \
        .astype(np.int64).tolist()


def ct_obs(K, ct):
    return {k: v.tobytes() for k, v in K.ct_np(ct).items()}


class TestHash:
    def test_np_jnp_agree(self):
        rng = np.random.default_rng(0)
        words = rng.integers(0, 2**32, size=(64, 10), dtype=np.uint32)

        def case(K):
            h_np = j_hash.hash_words_np(words) if K.side == "jax" \
                else t_hash.hash_words_np(words)
            h_dev = u32(K, K.hash(words))
            assert h_np.astype(np.int64).tolist() == h_dev
            return h_dev
        both(case)

    def test_avalanche(self):
        words = np.zeros((2, 10), dtype=np.uint32)
        words[1, 9] = 1

        def case(K):
            fn = j_hash.hash_words_np if K.side == "jax" \
                else t_hash.hash_words_np
            h = fn(words)
            assert h[0] != h[1]
            return h.tolist()
        both(case)


class TestLPMKernel:
    def test_matches_host_walk(self):
        entries = {"10.0.0.0/8": 100, "10.1.0.0/16": 200,
                   "10.1.2.3/32": 300, "2001:db8::/32": 400, "::/0": 500,
                   "0.0.0.0/0": 600}
        probes = ["10.1.2.3", "10.1.9.9", "10.2.3.4", "9.9.9.9",
                  "2001:db8::1", "fe80::1"]

        def case(K):
            C = K.C
            ids = sorted(set(entries.values()) | {C.IDENTITY_WORLD})
            index = {v: i for i, v in enumerate(ids)}
            tables = K.lpm.build_lpm(entries, index,
                                     default_index=index[C.IDENTITY_WORLD])
            addr_words = np.zeros((len(probes), 4), dtype=np.uint32)
            is_v6 = np.zeros(len(probes), dtype=bool)
            want = []
            for i, a in enumerate(probes):
                a16, v6 = K.ip.parse_addr(a)
                addr_words[i] = np.frombuffer(a16, dtype=">u4")
                is_v6[i] = v6
                want.append(K.lpm.lpm_lookup_host(tables, a16, v6))
            got = K.np(K.lpm_walk(tables, addr_words, is_v6,
                                  index[C.IDENTITY_WORLD]))
            np.testing.assert_array_equal(got, np.asarray(want))
            return got.astype(np.int64).tolist()
        both(case)


class TestL7Kernel:
    def test_matches_host(self):
        def case(K):
            C, HTTPRule = K.C, K.rules.HTTPRule
            interner = K.l7.L7SetInterner()
            s1 = interner.intern(frozenset({HTTPRule("GET", "/api"),
                                            HTTPRule("", "/pub")}))
            s2 = interner.intern(frozenset({HTTPRule("POST", "/x")}))
            t = K.l7.build_l7_tensors(interner)
            cases = [(s1, 0, b"/api/v1"), (s1, 1, b"/api"),
                     (s1, 1, b"/pub/z"), (s2, 1, b"/x"), (s2, 0, b"/x"),
                     (0, 0, b"/whatever"), (s1, 0, b""), (s2, 1, b"")]
            n = len(cases)
            path = np.zeros((n, C.L7_PATH_MAXLEN), dtype=np.uint8)
            for i, (_, _, p) in enumerate(cases):
                path[i, :len(p)] = np.frombuffer(p, dtype=np.uint8)
            got = K.np(K.l7_match(t, [c[0] for c in cases],
                                  [c[1] for c in cases], path))
            want = [K.l7.l7_match_host(t, sid, m, p) if sid > 0 else True
                    for sid, m, p in cases]
            np.testing.assert_array_equal(got, np.asarray(want))
            return got.tolist()
        both(case)


def _mk_batch(K, n, tuples):
    """``test_kernels._mk_batch`` over ``K``'s package: tuples of (src,
    dst, sport, dport, proto, dir)."""
    b = K.records.empty_batch(n)
    for i, (src, dst, sp, dp, proto, d) in enumerate(tuples):
        s16, sv6 = K.ip.parse_addr(src)
        d16, _dv6 = K.ip.parse_addr(dst)
        b["src"][i] = np.frombuffer(s16, dtype=">u4")
        b["dst"][i] = np.frombuffer(d16, dtype=">u4")
        b["sport"][i], b["dport"][i] = sp, dp
        b["proto"][i] = proto
        b["direction"][i] = d
        b["is_v6"][i] = sv6
        b["valid"][i] = True
    return b


def insert_obs(K, res):
    nk, ncr, zm, slot, fail, ev = res
    return (u32(K, nk), u32(K, ncr), K.np(zm).tolist(), u32(K, slot),
            K.np(fail).tolist(), int(K.np(ev)))


class TestCTKernel:
    def test_probe_miss_on_empty(self):
        def case(K):
            ct = K.ct(1024)
            b = K.batch(_mk_batch(K, 4, [("10.0.0.1", "10.0.0.2",
                                                  1, 2, 6, 0)] * 4))
            slot = K.np(K.probe(ct, K.keys(b), 100))
            assert (slot == -1).all()
            return slot.tolist()
        both(case)

    def test_insert_then_probe_hits(self):
        def case(K):
            ct = K.ct(1024)
            b = K.batch(_mk_batch(K, 4, [
                ("10.0.0.1", "10.0.0.2", 1000 + i, 80, 6, 0)
                for i in range(4)]))
            keys = K.keys(b)
            res = K.insert(ct, keys, [True] * 4, 100)
            nk, ncr, zm, slot, fail, _ev = res
            assert (K.np(slot) >= 0).all() and not K.np(fail).any()
            ct2 = K.apply(ct, b, slot, [True] * 4, 100, nk, ncr, zm)
            slot2 = K.probe(ct2, keys, 101)
            np.testing.assert_array_equal(K.np(slot2), K.np(slot))
            return insert_obs(K, res), ct_obs(K, ct2), u32(K, slot2)
        both(case)

    def test_duplicate_keys_one_slot(self):
        def case(K):
            ct = K.ct(1024)
            b = K.batch(_mk_batch(K, 4, [("10.0.0.1", "10.0.0.2",
                                                  7, 80, 6, 0)] * 4))
            res = K.insert(ct, K.keys(b), [True] * 4, 100)
            s = K.np(res[3])
            assert (s == s[0]).all() and (s >= 0).all()
            assert int(K.np(res[2]).sum()) == 1
            return insert_obs(K, res)
        both(case)

    def test_insert_fail_when_window_full(self):
        """Capacity 8, probe depth 8, 12 distinct flows: 8 claim a slot,
        at least 4 fail."""
        def case(K):
            ct = K.ct(8)
            tuples = [("10.0.0.1", "10.0.0.2", 100 + i, 80, 6, 0)
                      for i in range(12)]
            b = K.batch(_mk_batch(K, 12, tuples))
            res = K.insert(ct, K.keys(b), [True] * 12, 100)
            assert int(K.np(res[4]).sum()) >= 4
            assert int(K.np(res[2]).sum()) == 8
            return insert_obs(K, res)
        both(case)

    def test_sweep_reclaims(self):
        def case(K):
            C = K.C
            ct = K.ct(1024)
            raw = _mk_batch(K, 1, [("10.0.0.1", "10.0.0.2",
                                            7, 80, 6, 0)])
            raw["tcp_flags"][0] = C.TCP_SYN      # SYN only: 60 s to live
            b = K.batch(raw)
            keys = K.keys(b)
            nk, ncr, zm, slot, _fail, _ev = K.insert(ct, keys, [True], 100)
            ct2 = K.apply(ct, b, slot, [True], 100, nk, ncr, zm)
            ct3, n = K.sweep(ct2, 100 + C.CT_LIFETIME_SYN + 1)
            assert int(K.np(n)) == 1
            after = u32(K, K.probe(ct3, keys, 200))
            assert after == [0xFFFFFFFF]
            return ct_obs(K, ct2), int(K.np(n)), ct_obs(K, ct3), after
        both(case)

    def test_key_words_np_jnp_agree(self):
        def case(K):
            b = _mk_batch(K, 3, [
                ("10.0.0.1", "10.0.0.2", 5, 6, 17, 1),
                ("2001:db8::1", "2001:db8::2", 9, 10, 6, 0),
                ("1.1.1.1", "2.2.2.2", 0, 0, 1, 0)])
            seen = []
            for rev in (False, True):
                np_words = K.key_words_np(b, reverse=rev)
                dev_words = u32(K, K.keys(K.batch(b), reverse=rev))
                assert np_words.astype(np.int64).tolist() == dev_words
                seen.append(dev_words)
            return seen
        both(case)


def _pack_batch(records, n, n_valid=None, v6=False, l7=False, seed=0):
    """``TestPackOutVariants._batch`` over a package's ``records``."""
    rng = np.random.default_rng(seed)
    b = records.empty_batch(n)
    b["src"][:, 2] = 0xFFFF
    b["dst"][:, 2] = 0xFFFF
    b["src"][:, 3] = rng.integers(0, 2**32, n, dtype=np.uint32)
    b["dst"][:, 3] = rng.integers(0, 2**32, n, dtype=np.uint32)
    b["sport"][:] = rng.integers(0, 65536, n)
    b["dport"][:] = rng.integers(0, 65536, n)
    b["proto"][:] = rng.choice([6, 17, 1], n)
    b["tcp_flags"][:] = rng.integers(0, 256, n)
    b["ep_slot"][:] = rng.integers(0, 8, n)
    b["direction"][:] = rng.integers(0, 2, n)
    b["valid"][: n if n_valid is None else n_valid] = True
    if v6:
        b["is_v6"][::3] = True
        b["src"][::3, 0] = 0x20010DB8
    if l7:
        paths = [b"/api/v1", b"/submit", b"/", b"/static/app.js"]
        for i in range(0, n, 2):
            p = paths[i % len(paths)]
            b["http_method"][i] = i % 3
            b["http_path"][i, : len(p)] = np.frombuffer(p, np.uint8)
    return b


def wire(a):
    return a.shape, a.dtype.str, a.tobytes()


class TestPackOutVariants:
    """The ``out=`` packers give wires byte-identical to the allocating
    ones on every format, valid-masked buckets included; and the two
    packages' wires are equal."""

    def test_v4_out_bit_identical(self):
        def case(K):
            r = K.records
            b = _pack_batch(r, 32, n_valid=20)
            want = r.pack_batch_v4(b)
            out = np.full((32, r.PACK4_WORDS), 0xDEADBEEF, dtype=np.uint32)
            got = r.pack_batch_v4(b, out=out)
            np.testing.assert_array_equal(got, want)
            assert got.base is out or got is out
            return wire(got)
        both(case)

    def test_v4_out_oversized_prefix(self):
        def case(K):
            r = K.records
            b = _pack_batch(r, 16)
            out = np.zeros((64, r.PACK4_WORDS), dtype=np.uint32)
            got = r.pack_batch_v4(b, out=out)
            assert got.shape == (16, r.PACK4_WORDS)
            np.testing.assert_array_equal(got, r.pack_batch_v4(b))
            np.testing.assert_array_equal(out[:16], got)
            return wire(got), wire(out)
        both(case)

    def test_full_out_bit_identical(self):
        def case(K):
            r = K.records
            seen = []
            for v6 in (False, True):
                b = _pack_batch(r, 24, n_valid=17, v6=v6, seed=3)
                want = r.pack_batch(b)
                got = r.pack_batch(b, out=np.empty((24, want.shape[1]),
                                                   np.uint32))
                np.testing.assert_array_equal(got, want)
                seen.append(wire(got))
            return seen
        both(case)

    def test_full_out_l7_path_block(self):
        def case(K):
            r = K.records
            b = _pack_batch(r, 16, n_valid=9, l7=True, seed=4)
            want = r.pack_batch(b)
            assert want.shape[1] > r.PACK_WORDS
            got = r.pack_batch(b, out=np.empty_like(want))
            np.testing.assert_array_equal(got, want)
            return wire(got)
        both(case)

    def test_l7dict_out_both_variants(self):
        def case(K):
            r = K.records
            b = _pack_batch(r, 16, n_valid=11, l7=True, seed=5)
            w0, d0 = r.pack_batch_l7dict(b)
            assert w0.shape[1] == r.PACK4_L7_WORDS
            w1, d1 = r.pack_batch_l7dict(
                b, out=np.empty((16, r.PACK4_L7_WORDS), np.uint32))
            np.testing.assert_array_equal(w0, w1)
            np.testing.assert_array_equal(d0, d1)
            f0, e0 = r.pack_batch_l7dict(b, force_full=True)
            assert f0.shape[1] == r.PACK_L7DICT_WORDS
            f1, e1 = r.pack_batch_l7dict(
                b, force_full=True,
                out=np.empty((16, r.PACK_L7DICT_WORDS), np.uint32))
            np.testing.assert_array_equal(f0, f1)
            np.testing.assert_array_equal(e0, e1)
            return wire(w1), wire(d1), wire(f1), wire(e1)
        both(case)

    def test_out_mismatch_rejected(self):
        def case(K):
            r = K.records
            b = _pack_batch(r, 8)
            errors = []
            for out in (np.zeros((4, r.PACK4_WORDS), np.uint32),
                        np.zeros((8, r.PACK_WORDS), np.uint32),
                        np.zeros((8, r.PACK4_WORDS), np.int32)):
                with pytest.raises(ValueError) as e:
                    r.pack_batch_v4(b, out=out)
                errors.append(str(e.value))
            return errors
        both(case)
