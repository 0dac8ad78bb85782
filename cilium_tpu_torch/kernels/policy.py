"""Dense policy lookup: the whole wildcard ladder in three gathers (port of
``cilium_tpu/kernels/policy.py``).

Every gather is clipped first, reproducing the reference's clamp
semantics, and reads the flattened table. Besides the cell, the lookup
emits ``matched_rule``: the (id_class, port_class) coordinate of the
resolved cell, packed ``id_cls * n_port_classes + port_cls``.

The verdict image is uint16 in the reference; the port stores the same
bits as int16 (``convert.snapshot_tensors_to_torch``) and reads a cell
back with ``& 0xFFFF``.

On a rule-sharded mesh (``policy_lookup_batch`` with a ``RuleAxis``) the
verdict image's id-class rows are split across the rule shards: each
shard gathers the cells whose id class falls in its row range and writes
0 elsewhere, and the shards' cells are summed (the reference's psum over
the rules axis, here explicit moves to the flow shard's device and a
sum). ``matched_rule`` uses the global id class.
"""

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from cilium_tpu_torch.utils import constants as C


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Flat gather with the reference's clamp of out-of-range indices."""
    flat = table.reshape(-1)
    return flat[idx.to(torch.int64).clamp(0, flat.shape[0] - 1)]


def policy_core(tensors: Dict[str, torch.Tensor], ep_slot: torch.Tensor,
                direction: torch.Tensor, id_index: torch.Tensor,
                proto: torch.Tensor, dport: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """→ (decision [N] int32, l7_id [N] int32, enforced [N] bool,
    matched_rule [N] int32 — unmasked cell coordinate)."""
    n_ids = tensors["id_class_of"].shape[0]
    id_cls = _take(tensors["id_class_of"], id_index.clamp(0, n_ids - 1))
    fam = _take(tensors["proto_family"], proto.clamp(0, 255))
    n_ports = tensors["port_class"].shape[1]
    pcls = _take(tensors["port_class"],
                 fam.to(torch.int64) * n_ports + dport.clamp(0, n_ports - 1))
    v = tensors["verdict"]
    n_eps, n_rows, n_cols = v.shape[0], v.shape[2], v.shape[3]
    ep = ep_slot.clamp(0, n_eps - 1).to(torch.int64)
    d = direction.clamp(0, 1).to(torch.int64)
    cls = id_cls.clamp(0, n_rows - 1).to(torch.int64)
    pc = pcls.clamp(0, n_cols - 1).to(torch.int64)
    cell = _take(v, ((ep * 2 + d) * n_rows + cls) * n_cols + pc
                 ).to(torch.int32) & 0xFFFF
    enforced = _take(tensors["enforced"], ep * 2 + d).to(torch.bool)
    decision = cell & C.VERDICT_DECISION_MASK
    l7_id = cell >> C.VERDICT_L7_SHIFT
    matched_rule = (id_cls * n_cols + pcls).to(torch.int32)
    return decision, l7_id, enforced, matched_rule


class RuleAxis(NamedTuple):
    """The rules axis of a mesh as one flow shard sees it: the verdict rows
    each rule shard holds (``[n_eps, 2, rows_local, n_cols]``), in rule
    order, each on that rule shard's device. Rule shard ``r`` owns the
    global id-class rows ``[r * rows_local, (r + 1) * rows_local)``; the
    rule width is ``len(verdicts)``."""
    verdicts: List[torch.Tensor]


def rule_shard_cell(verdict_local: torch.Tensor, rule_index: int,
                    ep: torch.Tensor, d: torch.Tensor, id_cls: torch.Tensor,
                    pcls: torch.Tensor) -> torch.Tensor:
    """One rule shard's cell [N] int32 on its own device: the cell where
    ``id_cls`` falls in this shard's row range, 0 elsewhere."""
    dev = verdict_local.device
    ep, d, id_cls, pcls = ep.to(dev), d.to(dev), id_cls.to(dev), pcls.to(dev)
    rows_local, n_cols = verdict_local.shape[2], verdict_local.shape[3]
    local = id_cls - rule_index * rows_local
    in_range = (local >= 0) & (local < rows_local)
    safe = local.clamp(0, rows_local - 1)
    cell = _take(verdict_local, ((ep * 2 + d) * rows_local + safe) * n_cols
                 + pcls).to(torch.int32) & 0xFFFF
    return torch.where(in_range, cell, 0)


def policy_lookup_batch(tensors: Dict[str, torch.Tensor],
                        ep_slot: torch.Tensor, direction: torch.Tensor,
                        id_index: torch.Tensor, proto: torch.Tensor,
                        dport: torch.Tensor,
                        rule_axis: Optional[RuleAxis] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """→ (decision [N] int32, l7_id [N] int32, enforced [N] bool,
    matched_rule [N] int32). Without ``rule_axis`` the dense lookup
    (``policy_core``); with a :class:`RuleAxis` the sum of every rule
    shard's cell, on the device of ``id_index``."""
    if rule_axis is None:
        return policy_core(tensors, ep_slot, direction, id_index, proto,
                           dport)
    n_ids = tensors["id_class_of"].shape[0]
    id_cls = _take(tensors["id_class_of"],
                   id_index.clamp(0, n_ids - 1)).to(torch.int64)
    fam = _take(tensors["proto_family"], proto.clamp(0, 255))
    n_ports = tensors["port_class"].shape[1]
    pcls = _take(tensors["port_class"], fam.to(torch.int64) * n_ports
                 + dport.clamp(0, n_ports - 1)).to(torch.int64)
    v0 = rule_axis.verdicts[0]
    n_eps, n_cols = v0.shape[0], v0.shape[3]
    ep = ep_slot.clamp(0, n_eps - 1).to(torch.int64)
    d = direction.clamp(0, 1).to(torch.int64)
    pc = pcls.clamp(0, n_cols - 1)
    dev = id_index.device
    cell = torch.zeros(id_index.shape, dtype=torch.int32, device=dev)
    for r, v in enumerate(rule_axis.verdicts):
        cell = cell + rule_shard_cell(v, r, ep, d, id_cls, pc).to(dev)
    enforced = _take(tensors["enforced"], ep * 2 + d).to(torch.bool)
    decision = cell & C.VERDICT_DECISION_MASK
    l7_id = cell >> C.VERDICT_L7_SHIFT
    matched_rule = (id_cls * n_cols + pcls).to(torch.int32)
    return decision, l7_id, enforced, matched_rule
