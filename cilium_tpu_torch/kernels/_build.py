"""Builds and loads the CUDA kernels of ``cilium_tpu_torch/csrc/``.

Each ``.cu`` source has a plain C entry point (``*_launch``) and no
PyTorch headers, so ``nvcc`` builds it in seconds into its own shared
library, loaded with ``ctypes``; the wrappers in ``fused.py`` pass tensor
pointers and the current stream as integers. All sources compile at once,
one ``nvcc`` process each, for ``sm_90a`` with ``-O3``, into
``cilium_tpu_torch/_build/`` (listed in ``.gitignore``). A library's file
name carries a hash of its source, the shared headers (``csrc/*.cuh``) and
the flags, so an edit rebuilds it and an unchanged source is loaded as
built.

Nothing here runs at import: the first CUDA call of a kernel wrapper
builds. A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _LL, _I, _U = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_uint

#: library name → (source file, C entry point, its argument types)
KERNELS = {
    "lpm": ("lpm_lookup.cu", "lpm_lookup_launch",
            [_P, _P, _P, _LL, _P, _P, _P, _P, _I, _I, _LL, _P, _P, _P]),
    "ct_probe": ("ct_probe_pair.cu", "ct_probe_pair_launch",
                 [_P, _P, _LL, _P, _P, _LL, _U, _I, _P, _P, _P]),
    "policy": ("policy_verdict.cu", "policy_verdict_launch",
               [_P] * 10 + [_LL, _P, _LL, _P, _LL, _P, _LL, _LL, _P, _LL,
                            _LL, _LL, _P, _P, _P, _P, _P, _LL, _LL]
               + [_P] * 6),
    "flow_fp": ("flow_fingerprint.cu", "flow_fingerprint_launch",
                [_P] * 6 + [_LL, _P, _P]),
}

_LOCK = threading.Lock()
_FNS: Dict[str, object] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "cilium_tpu_torch need the CUDA toolkit")
    return found


def _target(src: str) -> str:
    """The library file for ``src``: named by a hash of the source, the
    shared headers of ``csrc/`` and the flags."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for name in (src, *headers):
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(src)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:12]}.so")


def build_all(verbose: bool = False) -> Dict[str, float]:
    """Build every kernel library that is not built yet, all ``nvcc``
    processes at once, then load them. → {library: seconds to build}
    (0.0 for one loaded as built). Raises on any compiler failure."""
    with _LOCK:
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = None
        procs = {}
        for name, (src, _fn, _args) in KERNELS.items():
            out = _target(src)
            if name in _FNS or os.path.exists(out):
                continue
            nvcc = nvcc or _nvcc()
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            cmd += ["-o", tmp, os.path.join(CSRC, src)]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out, time.perf_counter())
        seconds = {name: 0.0 for name in KERNELS}
        errors = []
        for name, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                errors.append(f"{KERNELS[name][0]}:\n{log}")
                continue
            if verbose and log:
                print(log, end="")
            os.replace(tmp, out)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        for name, (src, fn_name, argtypes) in KERNELS.items():
            if name not in _FNS:
                fn = getattr(ctypes.CDLL(_target(src)), fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _FNS[name] = fn
        return seconds


def launcher(name: str):
    """The C entry point of library ``name``, building on first use."""
    fn = _FNS.get(name)
    if fn is None:
        build_all()
        fn = _FNS[name]
    return fn
