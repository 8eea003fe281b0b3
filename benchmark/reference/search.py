"""Plain PyTorch reference of the int8 evidence index and its search.

The index holds each row as int8 with one float32 scale per group of 128
consecutive rows (the group's largest magnitude over 127, 1.0 for an
all-zero group), rounded to nearest. A search is exact: every stored row's
score ``q . (int8 row * scale)`` in float32, the top k.
"""

from __future__ import annotations

import torch


def quantize_rows(rows: torch.Tensor, group: int) -> torch.Tensor:
    """float rows [N, d] (N a multiple of ``group``) -> the float32 values
    the int8 index stores: round(row / scale) * scale per group."""
    n, d = rows.shape
    out = torch.empty((n, d), dtype=torch.float32, device=rows.device)
    step = 1024 * group
    for s in range(0, n, step):
        e = rows[s:s + step].float()
        g = e.view(-1, group * d)
        amax = g.abs().amax(dim=1, keepdim=True)
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        out[s:s + step] = (torch.clamp(torch.round(g / scale), -127, 127)
                           * scale).view(-1, d)
    return out


def exact_scores(queries: torch.Tensor, stored: torch.Tensor) -> torch.Tensor:
    """[nq, N] float32 scores of every stored row."""
    return torch.matmul(queries.float(), stored.T)
