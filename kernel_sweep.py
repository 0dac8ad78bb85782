#!/usr/bin/env python3
"""Times design variants of the K1, K2 and K3 CUDA kernels on one NVIDIA
card.

Run from the root of a checkout, with one CUDA device visible::

    python3 kernel_sweep.py [--seed N] [--kernels lpm,ct_probe,policy]
                            [--baseline DIR]

A variant is a kernel's committed source with a few literal edits
(``VARIANTS``), each of which must match the source exactly once:

- K1 (``lpm``): ``no_runs`` (the walk stops where it ends but crosses no
  run of single-child nodes in one step), ``unrolled`` (the two-family
  loop unrolled), ``T128``/``T64`` (rows a block);
- K2's lanes per key, ``kGroup`` set to 1, 2 or 8 (committed: 4);
- the L2 eviction hints of K2 and K3 dropped (``plain``): the variant is
  built beside a ``l2_hint.cuh`` whose loads are plain ``__ldg``
  (``PLAIN_L2_HINT``);
- ``--baseline DIR``: the ``lpm_lookup.cu``, ``ct_probe_pair.cu`` and
  ``policy_verdict.cu`` found in DIR (an earlier design). K2's and K3's
  must have the committed C entry points; K1's is the PR-1 design, which
  walks the snapshot's own planes for both families
  (``PR1_LPM_ARGTYPES``, launched through ``pr1_lpm_lookup``).

Each variant is built with ``_build``'s flags into
``cilium_tpu_torch/_build/variants/``, held exact against the plain torch
version on ``chip_smoke.py``'s kernel inputs at both worlds' widths, and
timed as ``chip_smoke.py`` times the kernels (``ms`` cold, ``hot_ms``,
``host_ms``), in two turns, forward then backward. Then the main path:
the cfg5 and mixed worlds' classify step under the profiler, 4 batches
per turn, with each set of ``path_sets`` in turns (A, B, ..., B, A): the
committed kernels, and for K1 each of its variants and the baseline, for
K2 and K3 their ``plain`` variants; each turn's device time per launch of
every kernel (``path_ms``), device-busy and wall ms. One JSON line per
measurement, then one line per variant with its turns' mean, then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import chip_smoke as cs
from cilium_tpu_torch.kernels import fused as fk

#: l2_hint.cuh with every load made plain: the same API, no cache policy
PLAIN_L2_HINT = """#pragma once
#include <cstdint>
#include <cuda_runtime.h>
namespace l2hint {
__device__ __forceinline__ uint64_t evict_first() { return 0; }
__device__ __forceinline__ uint64_t evict_last() { return 0; }
__device__ __forceinline__ uint8_t ld_u8(const uint8_t* a, uint64_t) {
  return __ldg(a);
}
__device__ __forceinline__ uint16_t ld_u16(const uint16_t* a, uint64_t) {
  return __ldg(a);
}
__device__ __forceinline__ uint32_t ld_u32(const uint32_t* a, uint64_t) {
  return __ldg(a);
}
__device__ __forceinline__ int32_t ld_i32(const int32_t* a, uint64_t) {
  return __ldg(a);
}
__device__ __forceinline__ uint64_t ld_u64(const uint64_t* a, uint64_t) {
  return __ldg(reinterpret_cast<const unsigned long long*>(a));
}
__device__ __forceinline__ uint4 ld_v4(const uint4* a, uint64_t) {
  return __ldg(a);
}
}  // namespace l2hint
"""

#: library → [(label, [(text, replacement), ...], plain loads?)]; the
#: first is the committed design
VARIANTS = {
    "lpm": [("committed", [], False),
            ("no_runs", [("if (c.w >= 0) {", "if (false) {")], False),
            ("unrolled", [("#pragma unroll 1\n", "#pragma unroll\n")],
             False),
            ("T128", [("kThreads = 256;", "kThreads = 128;")], False),
            ("T64", [("kThreads = 256;", "kThreads = 64;")], False)],
    "ct_probe": [("G4", [], False)]
    + [(f"G{g}", [("kGroup = 4;", f"kGroup = {g};")], False)
       for g in (1, 2, 8)]
    + [("plain", [], True)],
    "policy": [("committed", [], False), ("plain", [], True)],
}

#: library → the wrapper that launches it
WRAPPERS = {"lpm": "lpm_lookup_fused", "ct_probe": "ct_probe_pair_fused",
            "policy": "policy_verdict_fused"}

#: the committed K1 wrapper, which ``use`` puts back after the baseline's
COMMITTED_LPM = fk.lpm_lookup_fused

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
#: the PR-1 K1 entry point: (addr_words, is_v6, lpm_v4, n4, lpm_v6, n6,
#: default_index, v4_only, n, idx_out, meta_out, stream)
PR1_LPM_ARGTYPES = [_P, _P, _P, _LL, _P, _LL, _I, _I, _LL, _P, _P, _P]


def with_edits(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{old!r} is not in the source exactly once")
        text = text.replace(old, new)
    return text


def pr1_lpm_lookup(fn):
    """The PR-1 K1 wrapper over that design's entry point ``fn``, which
    walks the tries themselves: the same checks and launch as the PR-1
    ``lpm_lookup_fused``, so that ``host_ms`` compares."""
    import torch

    def lookup(lpm_v4, lpm_v6, addr_words, is_v6, default_index,
               v4_only=False):
        dev = addr_words.device
        n = addr_words.shape[0]
        addr_words = addr_words.contiguous()
        if addr_words.data_ptr() % 16:
            addr_words = addr_words.clone()
        idx = torch.empty((n,), dtype=torch.int32, device=dev)
        meta = torch.empty((n,), dtype=torch.int32, device=dev)
        if v4_only:
            v6_ptr, n6, isv6_ptr = None, 0, None
        else:
            v6_ptr = fk._ptr(lpm_v6, fk._I32, None, "lpm_v6", dev)
            n6 = lpm_v6.shape[0]
            isv6_ptr = fk._ptr(is_v6.contiguous(), fk._BOOL8, (n,), "is_v6",
                               dev, 1)
        rc = fn(fk._ptr(addr_words, fk._I32, (n, 4), "addr_words", dev, 16),
                isv6_ptr, fk._ptr(lpm_v4, fk._I32, None, "lpm_v4", dev),
                lpm_v4.shape[0], v6_ptr, n6, int(default_index),
                int(v4_only), n, idx.data_ptr(), meta.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        cs.check(rc == 0, f"PR-1 K1 launch failed (cudaError {rc})")
        fk.LAUNCHES["lpm_lookup_fused"] += 1
        return idx, meta
    return lookup


def build_variants(libs, baseline=None):
    """Build every variant of ``libs``, one ``nvcc`` process each, all at
    once. → {(library, label): C entry point}."""
    from cilium_tpu_torch.kernels import _build
    root = os.path.join(_build.BUILD_DIR, "variants")
    shutil.rmtree(root, ignore_errors=True)
    with open(os.path.join(_build.CSRC, "l2_hint.cuh")) as f:
        hints = f.read()
    shared = [f for f in os.listdir(_build.CSRC)
              if f.endswith(".cuh") and f != "l2_hint.cuh"]
    sources = {}
    for lib in libs:
        src = _build.KERNELS[lib][0]
        with open(os.path.join(_build.CSRC, src)) as f:
            text = f.read()
        for label, edits, plain in VARIANTS[lib]:
            sources[(lib, label)] = (
                src, with_edits(text, edits),
                PLAIN_L2_HINT if plain else hints)
        old = os.path.join(baseline, src) if baseline else None
        if old and os.path.exists(old):
            with open(old) as f:
                sources[(lib, "baseline")] = (src, f.read(), hints)
    nvcc = _build._nvcc()
    procs = {}
    for (lib, label), (src, text, header) in sources.items():
        where = os.path.join(root, f"{lib}-{label}")
        os.makedirs(where)
        # a quoted #include finds the header beside the source first
        with open(os.path.join(where, "l2_hint.cuh"), "w") as f:
            f.write(header)
        for name in shared:
            shutil.copy(os.path.join(_build.CSRC, name), where)
        with open(os.path.join(where, src), "w") as f:
            f.write(text)
        out = os.path.join(where, "lib.so")
        procs[(lib, label)] = (subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", out, os.path.join(where, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    fns = {}
    for key, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        _src, fn_name, argtypes = _build.KERNELS[key[0]]
        fn = getattr(ctypes.CDLL(out), fn_name)
        fn.argtypes = (PR1_LPM_ARGTYPES if key == ("lpm", "baseline")
                       else argtypes)
        fn.restype = ctypes.c_int
        fns[key] = fn
    return fns


def use(fns, lib, label):
    """Make ``lib``'s wrapper launch variant ``label``; K1's baseline,
    whose C entry point differs, launches through ``pr1_lpm_lookup``."""
    from cilium_tpu_torch.kernels import _build
    if lib == "lpm":
        fk.lpm_lookup_fused = (pr1_lpm_lookup(fns[(lib, label)])
                               if label == "baseline" else COMMITTED_LPM)
    if (lib, label) != ("lpm", "baseline"):
        _build._FNS[lib] = fns[(lib, label)]


def kernel_turns(worlds, fns, seed):
    """Every variant alone, exact then cold and hot, in two turns.
    → {(library, label, world): [(ms, hot_ms), ...]}."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = {}
    for w in worlds:
        b = cs.kernel_inputs(w, seed)
        largs = (w.tensors["lpm_v4"], w.tensors["lpm_v6"], cs.remote_words(b),
                 b["is_v6"], w.world_index, w.v4_only)
        cases[("lpm", w.name)] = (fk.lpm_lookup_plain, largs)
        ct, fwd, rev, now = cs.probe_case(w, seed + 1)
        cases[("ct_probe", w.name)] = (fk.ct_probe_pair_plain,
                                       (ct, fwd, rev, now, 8))
        idx, _meta = fk.lpm_lookup_plain(*largs)
        cases[("policy", w.name)] = (
            fk.policy_verdict_plain,
            (w.tensors, *cs.policy_rows(b, idx, gen)))
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device="cuda")
    order = sorted(fns)
    runs = {}
    for turn, seq in enumerate((order, order[::-1])):
        for lib, label in seq:
            use(fns, lib, label)
            wrapper = WRAPPERS[lib]
            symbol = cs.KERNELS[wrapper][2]
            for w in worlds:
                plain, kargs = cases[(lib, w.name)]

                def kernel(*a, _name=wrapper):
                    return getattr(fk, _name)(*a)
                err = cs.max_abs_err(kernel(*kargs), plain(*kargs))
                cs.check(err == 0, f"{lib} {label} {w.name}: max err {err}")
                cold = cs.device_ms(lambda: kernel(*kargs), symbol, 20, flush)
                hot = cs.device_ms(lambda: kernel(*kargs), symbol, 50)
                host = cs.host_ms(lambda: kernel(*kargs))
                runs.setdefault((lib, label, w.name), []).append(
                    (cold, hot, host))
                print(json.dumps({"kernel": lib, "variant": label,
                                  "world": w.name, "turn": turn, "ms": cold,
                                  "hot_ms": hot, "host_ms": host}),
                      flush=True)
        for lib in {k[0] for k in fns}:
            use(fns, lib, VARIANTS[lib][0][0])
    return runs


def path_sets(fns):
    """label → the variant of each library the main path runs: first the
    committed set, then each other K1 variant (the baseline among them),
    then K2 and K3 with plain loads."""
    committed = {lib: VARIANTS[lib][0][0] for lib in {k[0] for k in fns}}
    sets = {"committed": committed}
    for lib, label in sorted(fns):
        if lib == "lpm" and label != committed["lpm"]:
            sets[f"lpm-{label}"] = {**committed, "lpm": label}
    plain = {lib: "plain" for lib in committed if (lib, "plain") in fns}
    if plain:
        sets["plain"] = {**committed, **plain}
    return sets


def path_turns(worlds, fns):
    """The main path with each set of ``path_sets`` in turns (A, B, ...,
    B, A), 4 fresh batches a turn. → {(set, world): [stats, ...]}."""
    from cilium_tpu_torch.kernels.classify import make_classify_fn
    sets = path_sets(fns)
    labels = list(sets)
    order = labels + labels[::-1]
    runs = {}
    for w in worlds:
        fn = make_classify_fn(v4_only=w.v4_only, packed=True,
                              donate_ct=True, device=cs.DEVICE)
        for raw in w.warm_batches():
            fn(w.tensors, w.ct, w.pack(raw), 1000, w.world_index)
        wires = [w.pack(w.next_batch()) for _ in range(4 * len(order))]
        for turn, label in enumerate(order):
            for lib, variant in sets[label].items():
                use(fns, lib, variant)
            _lines, stats = cs.profile_lines(
                w, fn, wires[4 * turn:4 * turn + 4], 2000 + 4 * turn,
                w.name)
            runs.setdefault((label, w.name), []).append(stats)
            print(json.dumps({"path": label, "world": w.name, "turn": turn,
                              **stats}), flush=True)
    for lib, variant in sets["committed"].items():
        use(fns, lib, variant)
    return runs


def mean(xs):
    return sum(xs) / len(xs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", default=",".join(VARIANTS),
                    help="the libraries whose variants to time")
    ap.add_argument("--baseline", default=None,
                    help="a directory holding an earlier design's sources")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device", file=sys.stderr)
        return 2
    from cilium_tpu_torch.kernels import _build
    from cilium_tpu_torch.world import make_world

    card = cs.card_line()
    _build.build_all()
    fns = build_variants(args.kernels.split(","), args.baseline)
    worlds = [make_world(name, seed=args.seed, device=cs.DEVICE)
              for name in ("cfg5", "mixed")]
    runs = kernel_turns(worlds, fns, args.seed)
    paths = path_turns(worlds, fns)
    for (lib, label, world), turns in sorted(runs.items()):
        print(json.dumps({
            "kernel": lib, "variant": label, "world": world,
            "ms": mean([t[0] for t in turns]),
            "hot_ms": mean([t[1] for t in turns]),
            "host_ms": mean([t[2] for t in turns]), "card": card}))
    for (label, world), turns in paths.items():
        print(json.dumps({
            "path": label, "world": world,
            "path_ms": {k: mean([s["path_ms"][k] for s in turns])
                        for k in turns[0]["path_ms"]},
            "busy_ms": mean([s["busy_ms"] for s in turns]),
            "wall_ms": mean([s["wall_ms"] for s in turns]), "card": card}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
