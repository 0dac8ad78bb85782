"""The control of a cell's check, at the cell's own size: for each seed,
one run of the cell (the program, ``--seconds`` long), whose checked
dispatches are also handed, from the same batch-start tables, to the
control: the reference with the conntrack guarantee broken (every row
taken as NEW, the table unread), in the program's place. Prints, per seed,
the program's counts and the control's (a line each), and exits non-zero
unless every program count is 0 and the control fails on every seed.

    python3 benchmark/control.py --workload cfg5.serve --seconds 6 \\
        --seeds 11 12 13

Needs a CUDA device, as a run does. The benchmark's own runs never run it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

COUNTS = ("rows", "ct_slots", "counters")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    from benchmark.harness import cell as cells
    from benchmark.harness.runner import run_cell
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    ok = True
    for seed in args.seeds:
        res, _notes = run_cell(cell, seed, args.seconds, False, "cuda",
                               time.perf_counter(), control=True)
        checks = res["checks"]
        prog = {k: checks[f"{k}_mismatched"]["value"] for k in COUNTS}
        ctl = {k: checks[f"control_{k}"]["value"] for k in COUNTS}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "checked": checks["dispatches_checked"]["value"],
                          "program": prog, "control": ctl,
                          "correct": res["correct"]}), flush=True)
        ok &= res["correct"] and not any(prog.values()) \
            and any(ctl.values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
