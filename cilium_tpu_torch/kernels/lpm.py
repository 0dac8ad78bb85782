"""Batched LPM trie walk (port of ``cilium_tpu/kernels/lpm.py``).

Fixed-depth gather chain over the stride-8 node planes that
compile/lpm.py builds (``[n, 256, 3]`` int32: child, identity index,
packed provenance ``(prefix_slot << 8) | plen``). Dead paths idle in the
sentinel last node. A mixed-family batch walks both tries and selects by
the family bit; ``v4_only=True`` skips the 16-level v6 walk.

``lpm_walk_prov_core`` is the plain version of kernel K1
(``fused.lpm_lookup_fused``): the tests hold it against the JAX walk, and
the CUDA kernel is held against it on the card. Where both families
launch, the kernel walks tables derived from the tries (``lpm_derive``:
cells that end the walk where it ends and cross runs of single-child
nodes in one step); ``lpm_walk_derived`` is the plain version of that
walk, which the tests also hold against JAX.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from cilium_tpu_torch.compile import lpm as lpm_layout
from cilium_tpu_torch.kernels.hashing import i32, u32


def _walk(nodes: torch.Tensor, addr_words: torch.Tensor, first_byte: int,
          levels: int, default_index: int) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """nodes [n,256,3] int32; addr_words [N,4] (u32 bit patterns); level l
    reads byte ``first_byte + l`` of the 16-byte address. → (best identity
    index [N], best packed provenance [N], -1 on miss)."""
    dead = nodes.shape[0] - 1
    n = addr_words.shape[0]
    flat = nodes.reshape(-1, 3)
    node = torch.zeros((n,), dtype=torch.int64, device=addr_words.device)
    best = torch.full((n,), default_index, dtype=torch.int32,
                      device=addr_words.device)
    best_meta = torch.full((n,), -1, dtype=torch.int32,
                           device=addr_words.device)
    words = u32(addr_words)
    for level in range(levels):
        pos = first_byte + level
        b = (words[:, pos // 4] >> (8 * (3 - pos % 4))) & 0xFF
        triple = flat[node * 256 + b]             # [N, 3]
        child, value, meta = triple[:, 0], triple[:, 1], triple[:, 2]
        hit = value >= 0
        best = torch.where(hit, value, best)
        best_meta = torch.where(hit, meta, best_meta)
        node = torch.where(child >= 0, child, dead).to(torch.int64)
    return best, best_meta


def lpm_walk_prov_core(lpm_v4: torch.Tensor, lpm_v6: Optional[torch.Tensor],
                       addr_words: torch.Tensor,
                       is_v6: Optional[torch.Tensor], default_index: int,
                       v4_only: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N,4] v4-mapped address words → (identity index [N] int32, packed
    lpm_prefix provenance [N] int32, -1 on miss). ``v4_only`` elides the
    16-level v6 chain (``lpm_v6`` and ``is_v6`` may then be None)."""
    r4, m4 = _walk(lpm_v4, addr_words, 12, lpm_layout.V4_LEVELS,
                   default_index)
    if v4_only:
        return r4, m4
    assert lpm_v6 is not None and is_v6 is not None
    r6, m6 = _walk(lpm_v6, addr_words, 0, lpm_layout.V6_LEVELS,
                   default_index)
    v6 = is_v6.to(torch.bool)
    return torch.where(v6, r6, r4), torch.where(v6, m6, m4)


# --------------------------------------------------------------------------- #
# The derived walk tables that the CUDA kernel reads
# --------------------------------------------------------------------------- #
#: a cell's run field: ``(target node << RUN_K_BITS) | run length``
RUN_K_BITS = 5
#: runs are followed this far (a longer one covers every remaining level)
MAX_RUN = 16
_BYTE_SHIFTS = (24, 16, 8, 0)


class LpmDerived(NamedTuple):
    """The walk tables derived from one trie's node planes.

    ``cells [n, 256, 4]`` int32: child, value, meta, run. ``child`` is the
    original child, except that a cell without one holds -1 ("the walk
    ends here") where the trie keeps the dead-node invariant, and the dead
    node's index where it does not (the walk then runs to full depth, as
    the reference does). ``run`` is -1, or, where the child starts a run
    of single-child nodes (each with exactly one cell that changes the
    walk, holding a child and no value), ``(node past the run << 5) |
    length`` (length capped at ``MAX_RUN``).
    ``runs [n, 4]`` int32: the bytes such a run starting at each node
    matches, big-endian in four words, first byte at the top of word 0.
    """
    cells: torch.Tensor
    runs: torch.Tensor


def lpm_derive(nodes: torch.Tensor) -> LpmDerived:
    """Build the derived tables of ``nodes`` [n, 256, 3] int32 with torch
    ops on its device, reading nothing back to the host.

    A cell is inert when it has no child and no value: the walk goes to
    the dead node and ``best`` stays. The dead-node invariant holds when
    every cell of the last node is inert; then no level after a walk
    reaches it can change the result, and neither can a run whose bytes
    the address leaves (it reaches an inert cell, then the dead node)."""
    if nodes.dtype != torch.int32 or nodes.dim() != 3 \
            or tuple(nodes.shape[1:]) != (256, 3):
        raise ValueError(f"lpm table: expected [n, 256, 3] int32, got "
                         f"{list(nodes.shape)} {nodes.dtype}")
    n = nodes.shape[0]
    if n >= 1 << (31 - RUN_K_BITS):
        raise ValueError(f"lpm table of {n} nodes: at most "
                         f"{(1 << (31 - RUN_K_BITS)) - 1}")
    dev = nodes.device
    child, value, meta = nodes[..., 0], nodes[..., 1], nodes[..., 2]
    live = (child >= 0) | (value >= 0)
    keeps_dead = ~live[n - 1].any()          # 0-d bool, stays on the device
    only = live.to(torch.uint8).argmax(1)    # the first live cell's byte
    only_child = child.gather(1, only[:, None])[:, 0].to(torch.int64)
    pure = ((live.sum(1) == 1) & (only_child >= 0)
            & (value.gather(1, only[:, None])[:, 0] < 0))
    # follow each node's run of single-child nodes
    cur = torch.arange(n, device=dev)
    length = torch.zeros(n, dtype=torch.int64, device=dev)
    step = torch.ones(n, dtype=torch.bool, device=dev)
    run_bytes = torch.zeros((n, MAX_RUN), dtype=torch.int64, device=dev)
    for j in range(MAX_RUN):
        step = step & pure[cur]
        run_bytes[:, j] = torch.where(step, only[cur].to(torch.int64), 0)
        length = length + step.to(torch.int64)
        cur = torch.where(step, only_child[cur], cur)
    shifts = torch.tensor(_BYTE_SHIFTS, device=dev)
    runs = i32((run_bytes.view(n, 4, 4) << shifts).sum(-1))
    c = child.to(torch.int64).clamp(min=0)
    run = torch.where(keeps_dead & (child >= 0) & (length[c] > 0),
                      (cur[c] << RUN_K_BITS) | length[c], -1)
    ends = torch.where(keeps_dead, -1, n - 1)
    cells = torch.stack([torch.where(child >= 0, child, ends.to(torch.int32)),
                         value, meta, run.to(torch.int32)], -1)
    return LpmDerived(cells.contiguous(), runs.contiguous())


def _bytes(words: torch.Tensor) -> torch.Tensor:
    """[m, 4] int32 bit patterns → [m, 16] int64 bytes, big-endian."""
    shifts = torch.tensor(_BYTE_SHIFTS, device=words.device)
    return ((u32(words)[:, :, None] >> shifts) & 0xFF).reshape(-1, 16)


def _walk_derived(d: LpmDerived, addr_bytes, first_byte, default_index):
    """The CUDA kernel's walk over ``d``, row by row in lockstep. Each
    step loads one cell; a run's bytes load beside the cell past it, so
    a run costs no step of its own. → (best, best_meta, steps [N])."""
    n = addr_bytes.shape[0]
    dev = addr_bytes.device
    cells = d.cells.reshape(-1, 4)
    run_bytes = _bytes(d.runs)
    lanes = torch.arange(MAX_RUN, device=dev)
    pos = torch.full((n,), first_byte, dtype=torch.int64, device=dev)
    c = cells[addr_bytes[:, first_byte]]
    live = torch.ones((n,), dtype=torch.bool, device=dev)
    steps = torch.ones((n,), dtype=torch.int32, device=dev)
    best = torch.full((n,), int(default_index), dtype=torch.int32,
                      device=dev)
    best_meta = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for _ in range(MAX_RUN):
        hit = live & (c[:, 1] >= 0)
        best = torch.where(hit, c[:, 1], best)
        best_meta = torch.where(hit, c[:, 2], best_meta)
        pos = pos + 1
        child, run = c[:, 0].to(torch.int64), c[:, 3].to(torch.int64)
        live = live & (pos < 16) & (child >= 0)
        k = run & ((1 << RUN_K_BITS) - 1)
        jump = live & (run >= 0)
        live = live & ~(jump & (pos + k >= 16))
        jump = jump & live
        cols = (pos[:, None] + lanes).clamp(max=15)
        match = ((addr_bytes.gather(1, cols) == run_bytes[child.clamp(min=0)])
                 | (lanes >= k[:, None])).all(1)
        # a row that tries a run waits for its bytes, matched or not
        steps = steps + (live | jump).to(torch.int32)
        live = live & ~(jump & ~match)
        jump = jump & live
        pos = torch.where(jump, pos + k, pos)
        node = torch.where(jump, run >> RUN_K_BITS, child).clamp(min=0)
        at = node * 256 + addr_bytes.gather(1, pos.clamp(max=15)[:, None])[:, 0]
        c = cells[torch.where(live, at, 0)]
    return best, best_meta, steps


def lpm_walk_derived(d4: LpmDerived, d6: LpmDerived, addr_words, is_v6,
                     default_index):
    """The plain version of the CUDA kernel's own walk over the derived
    tables of both tries (a v4-only launch walks the v4 trie's planes
    instead, as ``lpm_walk_prov_core`` does). → (identity index [N] int32,
    packed provenance [N] int32, dependent loads per row [N] int32): the
    same results as ``lpm_walk_prov_core`` on the tables ``d4``/``d6``
    were derived from."""
    addr_bytes = _bytes(addr_words)
    r4, m4, s4 = _walk_derived(d4, addr_bytes, 12, default_index)
    r6, m6, s6 = _walk_derived(d6, addr_bytes, 0, default_index)
    v6 = is_v6.to(torch.bool)
    return (torch.where(v6, r6, r4), torch.where(v6, m6, m4),
            torch.where(v6, s6, s4))
