"""Neighbour pairs for the plain references: every ordered pair of
distinct cells closer than a cutoff, found through a cell list of plain
PyTorch operations (a sort by cube and a binary search per neighbour
cube).  Nothing here comes from the program under test."""
from __future__ import annotations

import torch

# cells of one neighbour-cube offset handled at once (bounds the memory)
CHUNK = 1 << 20


def cube_coords(v, cube_size, grid):
    """Cube coordinate of one axis, ``floor(v / cube_size) + grid // 2``
    clipped into ``[0, grid)``."""
    c = torch.floor(v / cube_size).to(torch.int64) + grid // 2
    return torch.clamp(c, 0, grid - 1)


def distance(x, y, z, i, j):
    """``|p_i - p_j|``, the difference, products and sums taken in the
    order the pair forces take them."""
    rx, ry, rz = x[i] - x[j], y[i] - y[j], z[i] - z[j]
    return torch.sqrt(rx * rx + ry * ry + rz * rz)


def cell_pairs(x, y, z, n, cutoff):
    """``(i, j, dist)``: every ordered pair of distinct rows ``i, j < n``
    with ``dist < cutoff``, sorted by ``i`` then ``j``."""
    dev = x.device
    if n == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return empty, empty, x[:0]
    c = [torch.floor(a[:n].float() / cutoff).to(torch.int64)
         for a in (x, y, z)]
    c = [a - a.min() + 1 for a in c]               # one empty layer below
    gx, gy = int(c[0].max()) + 2, int(c[1].max()) + 2
    key = (c[2] * gy + c[1]) * gx + c[0]
    skey, order = torch.sort(key)
    rows = torch.arange(n, device=dev)
    out_i, out_j = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                nkey = key + (dz * gy + dy) * gx + dx
                start = torch.searchsorted(skey, nkey)
                count = torch.searchsorted(skey, nkey, right=True) - start
                for lo in range(0, n, CHUNK):
                    cnt = count[lo:lo + CHUNK]
                    i = torch.repeat_interleave(rows[lo:lo + CHUNK], cnt)
                    first = torch.cumsum(cnt, 0) - cnt
                    k = torch.arange(i.numel(), device=dev) - \
                        torch.repeat_interleave(first, cnt)
                    j = order[start[i] + k]
                    keep = (i != j) & (distance(x, y, z, i, j) < cutoff)
                    out_i.append(i[keep])
                    out_j.append(j[keep])
    i, j = torch.cat(out_i), torch.cat(out_j)
    perm = torch.argsort(i * n + j)
    i, j = i[perm], j[perm]
    return i, j, distance(x, y, z, i, j)
