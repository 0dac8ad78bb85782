"""Where a run ran: the card, its power limit and clocks, the revision."""

import os
import subprocess


def _smi(query: str):
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable: {e}"
    return r.stdout.strip() if r.returncode == 0 else \
        f"unavailable: {r.stderr.strip()}"


def _revision():
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        r = subprocess.run(["git", "rev-parse", "HEAD"], cwd=root,
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip() if r.returncode == 0 else None


def provenance():
    import torch
    return {"device": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count(),
            "smi": _smi("name,power.limit,clocks.sm,clocks.max.sm"),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "revision": _revision()}
