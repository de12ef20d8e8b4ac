"""All-pairs O(N^2) pairwise engine: the brute-force oracle.

Counterpart of ``yalla_tpu/ops/pairwise_xla.py``: j is streamed in blocks
so only an ``[n_pad, j_block]`` pair block is live at a time.  All pairs
are evaluated, including i == j (models put reaction terms on the
diagonal).
"""
from __future__ import annotations

import torch

from .common import evaluate_pairs

__all__ = ["tile_pairwise"]


def tile_pairwise(pw_int, pw_friction, X, old_v, n, *, j_block=1024,
                  i_offset=0, i_size=None):
    """Pairwise sums of the points ``[i_offset, i_offset + i_size)``
    (default: all of them) against every one of the first ``n`` points.

    Returns (dF (Pt [i_size]), sum_friction [i_size], sum_v ([i_size],) * 3,
    aux dict of [i_size])."""
    n_pad = X.x.shape[0]
    if i_size is None:
        i_size = n_pad - i_offset
    idx = torch.arange(n_pad, device=X.x.device)
    Xi = type(X)(*(a[i_offset:i_offset + i_size, None] for a in X))
    i_arr = idx[i_offset:i_offset + i_size, None]
    total = None
    for j0 in range(0, n_pad, j_block):
        jb = idx[j0:j0 + j_block]
        Xj = type(X)(*(a[None, jb] for a in X))
        ovj = tuple(v[None, jb] for v in old_v)
        pair_mask = (i_arr < n) & (jb < n)[None, :]
        out = evaluate_pairs(pw_int, pw_friction, Xi, Xj, ovj, i_arr,
                             jb[None, :], pair_mask, sum_axes=(1,))
        if total is None:
            total = out
            continue
        F, sum_f, sum_v, aux = total
        total = (F + out[0], sum_f + out[1],
                 tuple(a + b for a, b in zip(sum_v, out[2])),
                 {k: aux[k] + out[3][k] for k in aux})
    return total
