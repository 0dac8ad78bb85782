"""L7-lite tokenized HTTP match (port of ``cilium_tpu/kernels/l7.py``).

Per packet: gather its rule set's tensors and compare the method and the
64-byte path prefix against every rule of the set. Set id 0 (no redirect)
vacuously matches.
"""

from __future__ import annotations

from typing import Dict

import torch

from cilium_tpu_torch.utils import constants as C


def l7_match_core(tensors: Dict[str, torch.Tensor], set_id: torch.Tensor,
                  method: torch.Tensor, path: torch.Tensor) -> torch.Tensor:
    """set_id [N] int32 (0 = none), method [N] int32, path [N,64] uint8
    → matched [N] bool (True for set_id <= 0)."""
    sid = set_id.clamp(0, tensors["l7_methods"].shape[0] - 1).to(torch.int64)
    m = tensors["l7_methods"][sid].to(torch.int32)          # [N,R]
    valid = tensors["l7_valid"][sid].to(torch.bool)                 # [N,R]
    plen = tensors["l7_path_len"][sid]                      # [N,R]
    prefix = tensors["l7_path"][sid]                        # [N,R,64]
    m_ok = (m == C.HTTP_METHOD_ANY) | (m == method[:, None])
    pos = torch.arange(prefix.shape[-1], dtype=torch.int32,
                       device=prefix.device)
    byte_ok = ((prefix == path[:, None, :])
               | (pos[None, None, :] >= plen[:, :, None]))
    p_ok = byte_ok.all(dim=-1)
    any_rule = (valid & m_ok & p_ok).any(dim=-1)
    return (set_id <= 0) | any_rule
