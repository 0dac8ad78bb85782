"""The benchmark of ``cilium_tpu_torch``: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout on a machine with as many CUDA devices as
the cell asks for. Builds the cell's world through ``Engine``, warms up,
drives the window, checks the outputs against the plain reference under
``benchmark/reference``, and prints, as its last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics; with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number the check compared, with its limit (``most`` or ``least``). The
same numbers end standard error. Provenance (the card, its power limit and
clocks, the revision) is printed on an earlier line. Exits non-zero, with
no result, without a CUDA device, or when JAX or the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cell as cells
    from benchmark.harness.provenance import provenance
    from benchmark.harness.runner import forbidden_modules, run_cell
    cell = cells.load(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print("provenance: " + json.dumps(provenance()), flush=True)
    result, notes = run_cell(cell, args.seed, args.seconds,
                             bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded modules that no run may load: {found}",
              file=sys.stderr)
        return 3
    print("window: " + json.dumps(notes), flush=True)
    for name, c in result["checks"].items():
        limit = (f"at most {c['most']}" if "most" in c
                 else f"at least {c['least']}")
        print(f"check {name}: {c['value']} ({limit})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
