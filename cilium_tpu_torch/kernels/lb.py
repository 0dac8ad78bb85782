"""Device LB step: frontend hash-table lookup → Maglev backend select →
DNAT rewrite (port of ``cilium_tpu/kernels/lb.py``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from cilium_tpu_torch.kernels.hashing import hash_words_u64, i32, u32


def lb_step(tensors: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], probe_depth: int = 8
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    """→ (new_dst [N,4], new_dport [N], rev_nat [N], no_backend [N]).

    ``rev_nat`` is the frontend's stable rev-NAT id + 1 (0 = untranslated);
    ``no_backend`` marks packets addressed to a frontend whose service has
    no backends (dropped with NO_SERVICE by the caller)."""
    dst = batch["dst"]
    keys = torch.cat([dst, batch["dport"][:, None].to(torch.int32),
                      batch["proto"][:, None].to(torch.int32)], dim=-1)

    tab_keys = tensors["lb_tab_keys"]
    tab_val = tensors["lb_tab_val"]
    cap = tab_keys.shape[0]
    base = hash_words_u64(keys) & (cap - 1)
    fe_idx = torch.full(base.shape, -1, dtype=torch.int32, device=dst.device)
    for d in range(probe_depth):
        s = (base + d) & (cap - 1)
        eq = (tab_keys[s] == keys).all(dim=-1) & (tab_val[s] >= 0)
        fe_idx = torch.where((fe_idx < 0) & eq, tab_val[s], fe_idx)

    hit = (fe_idx >= 0) & batch["valid"]
    safe_fe = torch.where(hit, fe_idx, 0).to(torch.int64)

    src = batch["src"]
    port_w = i32((u32(batch["sport"]) << 16) | u32(batch["dport"]))
    proto_w = i32(u32(batch["proto"]) << 8)
    sel_words = torch.cat([src, dst, port_w[:, None], proto_w[:, None]],
                          dim=-1)
    maglev = tensors["lb_maglev"]
    m = maglev.shape[1]
    slot = hash_words_u64(sel_words) % m
    svc_row = tensors["lb_fe_service"][safe_fe].to(torch.int64)
    be = maglev[svc_row.clamp(0, maglev.shape[0] - 1), slot]

    no_backend = hit & (be < 0)
    do = hit & (be >= 0)
    safe_be = torch.where(do, be, 0).to(torch.int64)
    new_dst = torch.where(do[:, None], tensors["lb_be_addr"][safe_be], dst)
    new_dport = torch.where(do, tensors["lb_be_port"][safe_be],
                            batch["dport"])
    rev_nat = torch.where(do, tensors["lb_fe_rnat_id"][safe_fe] + 1,
                          0).to(torch.int32)
    return new_dst, new_dport, rev_nat, no_backend
