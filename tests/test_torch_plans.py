"""Launch plans of the redesigned pair kernels, on the CPU.

``lattice_plan`` (K1, ``csrc/lattice_pair.cu``) cuts the cube lattice into
bricks whose halo and sums fit the H100's shared memory; ``tile_plan``
(K3, ``csrc/tile_pair.cu``) splits the all-pairs j range across blocks,
and ``central_plan`` (K4, ``csrc/central_pair.cu``) does the same for
the central kernel's rows and sums; ``pour_plan`` (K2, ``csrc/pour.cu``)
gives each block whole rows of slots; ``gabriel_plan`` (K5,
``csrc/gabriel_pair.cu``) cuts the lattice into bricks whose halo of live
points and compact sets fit.  All are plain Python, so their
arithmetic is held here: every cube in exactly one brick, every j in
exactly one split, every row in one block, shared memory and scratch as
the kernels lay them out.  Also: the plain lattice pass on an empty
lattice (K1's empty edge shape).
"""
import itertools

import numpy as np
import pytest
import torch

from yalla_tpu_torch.dtypes import Float3
from yalla_tpu_torch.models import branching as B
from yalla_tpu_torch.ops.central_mxu import CENTRAL_ROWS, central_plan
from yalla_tpu_torch.ops.common import friction_w_neighbour
from yalla_tpu_torch.ops import gabriel_pallas as G
from yalla_tpu_torch.ops.gabriel_pallas import (GABRIEL_MAX_NC,
                                                gabriel_plan,
                                                gabriel_smem_bytes)
from yalla_tpu_torch.ops.lattice_pallas import (BRICKS, SMEM_BUDGET,
                                                SMEM_MAX,
                                                lattice_pairwise_plain,
                                                lattice_plan,
                                                lattice_smem_bytes)
from yalla_tpu_torch.ops.lattice_pour import BLOCK_SLOTS, pour_plan
from yalla_tpu_torch.ops.lattice_xla import lattice_build
from yalla_tpu_torch.ops.tile_pallas import (BLOCKS_PER_SM, TILE_J,
                                             TILE_THREADS, tile_plan)
from yalla_tpu_torch.solvers import augment

# the lattices the port runs (500k branching; the 600-cell state; K5's
# two lattices, which K2 builds; Solution's default grid of 50) and edge
# shapes: C 1, C 16 at gs 32, grids no brick divides, a flat grid
LATTICES = [(64, 8), (32, 4), (16, 8), (48, 16), (50, 8), (32, 1), (32, 16),
            ((10, 7, 3), 8), ((11, 11, 11), 8), ((5, 5, 1), 3),
            # the flagship's first tier and its full-width lattice
            (24, 16), (88, 16)]
# the H100's streaming multiprocessors (the wrapper reads the card's count)
H100_SMS = 132


# the lattice kernel's functors' channels: branching (x y z u v ctype px
# py pz and old_v) and intercalation_w_gradient (x y z w f ctype, the
# seven polarity precompute channels and old_v)
CHANS = (12, 16)


@pytest.mark.parametrize("n_chans", CHANS)
@pytest.mark.parametrize("grid,capacity", LATTICES)
def test_lattice_plan_tiles_the_grid(grid, capacity, n_chans):
    plan = lattice_plan(grid, capacity, n_chans)
    gx, gy, gz = (grid,) * 3 if isinstance(grid, int) else grid
    bz, by, bx = plan.brick
    assert plan.smem == lattice_smem_bytes(plan.brick, capacity, n_chans)
    assert plan.smem <= SMEM_BUDGET < SMEM_MAX
    # two blocks per SM, 1 KB reserved each
    assert 2 * (plan.smem + 1024) <= 233_472
    assert bz <= gz and by <= gy and bx <= gx
    # the kernel's block -> brick origin arithmetic covers every cube once
    nbx, nby = -(-gx // bx), -(-gy // by)
    seen = np.zeros((gz, gy, gx), np.int64)
    for b in range(plan.blocks):
        x0, y0, z0 = b % nbx * bx, b // nbx % nby * by, b // (nbx * nby) * bz
        seen[z0:z0 + bz, y0:y0 + by, x0:x0 + bx] += 1
    assert (seen == 1).all()
    # the largest brick that fits the budget is taken
    fits = [min(b[0], gz) == bz and min(b[1], gy) == by
            and min(b[2], gx) == bx for b in BRICKS]
    for b in BRICKS[:fits.index(True)]:
        clipped = (min(b[0], gz), min(b[1], gy), min(b[2], gx))
        assert lattice_smem_bytes(clipped, capacity, n_chans) > SMEM_BUDGET
    # the halo's occupancy is staged in the partner lists' room (the
    # kernel refuses a larger halo)
    hz, hy, hx = bz + 2, by + 2, bx + 2
    assert hx * hy * hz * capacity <= 4 * 8 * 256


@pytest.mark.parametrize("capacity", [1, 4, 8, 16, 24])
def test_lattice_smem_bytes_at_12_channels_unchanged(capacity):
    """At branching's 12 channels the shared memory of every brick is the
    sum the kernel laid out before it took the channel count from its
    functor: 52 bytes a halo slot (a 16-byte list entry and 9 channels),
    the row counts, the extras runs, the work list and the partner
    lists."""
    for bz, by, bx in BRICKS:
        hx, rows = bx + 2, (by + 2) * (bz + 2)
        H, B = hx * rows, bz * by * bx
        before = 16 * H * capacity + 36 * H * capacity \
            + 4 * rows * (hx + 1) + 8 * H + 4 * (B + 1) \
            + 4 * B * capacity + 4 * 8 * 256
        assert lattice_smem_bytes((bz, by, bx), capacity, 12) == before
        # 16 channels: 16 bytes more a halo slot
        assert lattice_smem_bytes((bz, by, bx), capacity, 16) \
            == before + 16 * H * capacity


def test_lattice_plan_main_path_and_refusals():
    plan = lattice_plan(64, 8, 12)
    assert plan.brick == (2, 4, 8) and plan.blocks == 4096
    assert plan.smem == 113_316
    assert lattice_plan(48, 16, 12).brick == (1, 2, 8)
    # the wrapper asks once per shape
    assert lattice_plan(64, 8, 12) is plan
    # intercalation_w_gradient's 16 channels on the lattice its embryo
    # gets (grid 32, C 8): a smaller brick than branching's there
    assert lattice_plan(32, 8, 12).brick == (2, 4, 8)
    iwg = lattice_plan(32, 8, 16)
    assert iwg.brick == (2, 2, 8) and iwg.smem == 98_372
    assert iwg.blocks == 1024
    # at C 16, 16 channels take (1, 1, 8) where 12 take (1, 2, 8)
    assert lattice_plan(48, 16, 16).brick == (1, 1, 8)
    # one cube and its halo past 227 KB: no brick fits
    with pytest.raises(ValueError, match="shared memory"):
        lattice_plan(8, 200, 12)
    with pytest.raises(ValueError):
        lattice_plan(8, 0, 12)
    with pytest.raises(ValueError, match="shared memory"):
        lattice_plan(8, 256, 12)
    with pytest.raises(ValueError):
        lattice_plan(2048, 8, 12)            # slot ids past 2^31
    with pytest.raises(ValueError):
        lattice_plan(8, 8, 2)                # fewer than x, y, z


@pytest.mark.parametrize("n_max", B.tier_caps(500_000) + [900_000])
def test_lattice_plan_fits_the_flagship_tiers(n_max):
    """The lattice the flagship's ``default_engine`` picks on the card at
    each capacity tier, and for the 900,000 cells ``chip_smoke.py`` makes
    room for (the occupancy planned for a dividing tissue less the two the
    extras take, on the final population's extent), fits the pair kernel's
    shared-memory budget and the pour's plan."""
    engine = B.engine_on(True, n_max)
    gs, C = engine.grid_size, engine.capacity
    assert isinstance(gs, int) and engine.extras_cap == 4096
    assert C >= 14 and gs * C % 128 == 0
    plan = lattice_plan(gs, C, 12)
    assert plan.smem <= SMEM_BUDGET and plan.blocks >= 132
    rows, blocks = pour_plan(gs * gs, gs * C)
    # every row of cubes in one block, no row wider than a block's map
    assert rows * blocks >= gs * gs and gs * C <= 4096
    if n_max in (4096, 900_000):
        assert (gs, C) in LATTICES


def _brick_cover(plan, grid):
    """How often the kernels' block -> brick origin arithmetic covers each
    cube of ``grid``: an int array [gz, gy, gx]."""
    gx, gy, gz = (grid,) * 3 if isinstance(grid, int) else grid
    bz, by, bx = plan.brick
    nbx, nby = -(-gx // bx), -(-gy // by)
    seen = np.zeros((gz, gy, gx), np.int64)
    for b in range(plan.blocks):
        x0, y0, z0 = b % nbx * bx, b // nbx % nby * by, b // (nbx * nby) * bz
        seen[z0:z0 + bz, y0:y0 + by, x0:x0 + bx] += 1
    return seen


@pytest.mark.parametrize("max_candidates", [1, 32, GABRIEL_MAX_NC])
@pytest.mark.parametrize("grid,capacity", LATTICES)
def test_gabriel_plan_tiles_the_grid(grid, capacity, max_candidates):
    """K5's plan: every cube in exactly one brick, ragged edges included;
    shared memory as the kernel lays it out, three blocks to an SM; the
    staged list within its 15-bit places; the largest brick that fits."""
    plan = gabriel_plan(grid, capacity, max_candidates)
    gx, gy, gz = (grid,) * 3 if isinstance(grid, int) else grid
    bz, by, bx = plan.brick
    assert plan.smem == gabriel_smem_bytes(plan.brick, capacity,
                                           max_candidates)
    assert plan.smem <= G.SMEM_BUDGET < G.SMEM_MAX
    assert 3 * (plan.smem + 1024) <= 233_472
    # a cube's slots are strided by the capacity rounded up to a power of 2
    stride = 1 << (capacity - 1).bit_length()
    assert capacity <= stride < 2 * capacity
    assert (bz + 2) * (by + 2) * (bx + 2) * stride <= G.GABRIEL_MAX_STAGED
    assert bz <= gz and by <= gy and bx <= gx
    assert (_brick_cover(plan, grid) == 1).all()
    fits = [min(b[0], gz) == bz and min(b[1], gy) == by
            and min(b[2], gx) == bx for b in G.BRICKS]
    for b in G.BRICKS[:fits.index(True)]:
        clipped = (min(b[0], gz), min(b[1], gy), min(b[2], gx))
        assert gabriel_smem_bytes(clipped, capacity, max_candidates) > \
            G.SMEM_BUDGET


def test_gabriel_plan_main_path_and_refusals():
    # the 100k growth_w_wall path: 4 x 4 x 4 cubes a block, 216 in its halo
    plan = gabriel_plan(48, 16, 32)
    assert plan.brick == (4, 4, 4) and plan.blocks == 12 ** 3
    assert plan.smem == 16 * 216 * 16 + 8 * 216 + 16 + 2 * 64 * 16 + \
        2 * 64 * 32 == 63_184
    # C 6 strides its cubes by 8
    assert gabriel_smem_bytes((1, 1, 1), 6, 1) == 16 * 27 * 8 + 8 * 27 + \
        16 + 2 * 6 + 2 * 64
    # the largest compact set costs 12 KB more and keeps the brick
    big = gabriel_plan(48, 16, GABRIEL_MAX_NC)
    assert big.brick == (4, 4, 4) and big.smem == plan.smem + 2 * 64 * 96
    # a capacity whose 4 x 4 x 4 halo is past the budget takes less
    assert gabriel_plan(48, 32, 32).brick == (2, 2, 4)
    # the wrapper asks once per shape
    assert gabriel_plan(48, 16, 32) is plan
    # one cube and its halo past 227 KB: no brick fits
    with pytest.raises(ValueError, match="shared memory"):
        gabriel_plan(8, 600, 32)
    with pytest.raises(ValueError, match="staged slots"):
        gabriel_plan(8, 2000, 32)
    for bad in ((8, 0, 32), (8, 8, 0), (2048, 8, 32)):
        with pytest.raises(ValueError):
            gabriel_plan(*bad)


def _tile_cases():
    for n in (0, 1, 127, 600, 5000):
        for n_pad in sorted({n, -(-n // 128) * 128, 5120}):
            for rows, sums in ((2, 13), (4, 7)):
                yield n, n_pad, rows, sums


@pytest.mark.parametrize("n,n_pad,rows,sums", list(_tile_cases()))
def test_tile_plan_splits_j_once(n, n_pad, rows, sums):
    plan = tile_plan(n, n_pad, rows, sums, H100_SMS)
    assert plan.rows == rows
    i_blocks, splits = plan.blocks
    assert splits == plan.splits >= 1 and plan.chunk >= 1
    # every row in exactly one block's i range
    per_block = TILE_THREADS * rows
    assert i_blocks * per_block >= n_pad > (i_blocks - 1) * per_block \
        or (n_pad == 0 and i_blocks == 0)
    # every j < n in exactly one split, and no split empty
    ranges = [(s * plan.chunk, min(n, (s + 1) * plan.chunk))
              for s in range(splits)]
    covered = list(itertools.chain.from_iterable(range(*r) for r in ranges))
    assert covered == list(range(n))
    assert all(hi > lo for lo, hi in ranges) or (n == 0 and splits == 1)
    assert plan.scratch == (splits, sums, n_pad)
    # no more splits than tiles of j
    assert splits <= max(1, -(-n // TILE_J))


def test_tile_plan_fills_the_card_at_5k():
    for rows, sums in ((2, 13), (4, 7)):
        plan = tile_plan(5000, 5120, rows, sums, H100_SMS)
        blocks = plan.blocks[0] * plan.blocks[1]
        # at most BLOCKS_PER_SM blocks on any SM, at least one less on none
        assert (BLOCKS_PER_SM - 1) * H100_SMS < blocks <= \
            BLOCKS_PER_SM * H100_SMS, plan
        assert tile_plan(5000, 5120, rows, sums, H100_SMS) is plan
    # fewer SMs, fewer splits
    assert tile_plan(5000, 5120, 4, 7, 16).splits < \
        tile_plan(5000, 5120, 4, 7, H100_SMS).splits
    with pytest.raises(ValueError):
        tile_plan(10, 5, 2, 13, H100_SMS)
    with pytest.raises(ValueError):
        tile_plan(10, 20, 2, 13, 0)


def _central_cases():
    for n in (0, 1, 50, 127, 900, 5000):
        for n_pad in sorted({n, 64, 1000, -(-n // 128) * 128, 5120}):
            if n <= n_pad:
                for n_aux in (0, 1):
                    yield n, n_pad, n_aux


@pytest.mark.parametrize("n,n_pad,n_aux", list(_central_cases()))
def test_central_plan_splits_j_once(n, n_pad, n_aux):
    """K4's plan: R i-points a thread over every row, every j < n in
    exactly one split, no split empty, scratch [S, 8 + aux, n_pad]."""
    plan = central_plan(n, n_pad, n_aux, H100_SMS)
    assert plan.rows == CENTRAL_ROWS
    i_blocks, splits = plan.blocks
    per_block = TILE_THREADS * CENTRAL_ROWS
    assert i_blocks == -(-n_pad // per_block)
    ranges = [(s * plan.chunk, min(n, (s + 1) * plan.chunk))
              for s in range(splits)]
    covered = list(itertools.chain.from_iterable(range(*r) for r in ranges))
    assert covered == list(range(n))
    assert all(hi > lo for lo, hi in ranges) or (n == 0 and splits == 1)
    assert plan.scratch == (splits, 8 + n_aux, n_pad)


def test_central_plan_fills_the_card_at_5k():
    plan = central_plan(5000, 5120, 0, H100_SMS)
    assert plan.blocks == (10, 52)           # 520 blocks on 132 SMs
    # the aux channels change the scratch, not the split
    assert central_plan(5000, 5120, 1, H100_SMS).blocks == plan.blocks


@pytest.mark.parametrize("grid,capacity", LATTICES)
def test_pour_plan_gives_each_row_one_block(grid, capacity):
    """K2's plan: whole rows a block, every row in exactly one block
    (block b owns rows [b * rows, (b + 1) * rows)), at most BLOCK_SLOTS
    slots a block unless one row is wider."""
    gx, gy, gz = (grid,) * 3 if isinstance(grid, int) else grid
    n_rows, W = gy * gz, gx * capacity
    rows, blocks = pour_plan(n_rows, W)
    assert (blocks - 1) * rows < n_rows <= blocks * rows
    assert rows == 1 or rows * W <= BLOCK_SLOTS
    # the 500k lattice: 2 rows of 512 slots a block; the 100k lattice: 1
    assert pour_plan(64 * 64, 64 * 8) == (2, 2048)
    assert pour_plan(48 * 48, 48 * 16) == (1, 2304)


def test_plain_lattice_pass_on_an_empty_lattice():
    """K1's plain version (the kernel's oracle) on a lattice with no cell:
    every sum zero, the extras' too."""
    n_pad = 64
    rng = np.random.default_rng(0)
    X = B.Cell(*(torch.as_tensor(rng.random(n_pad, np.float32))
                 for _ in B.Cell._fields))
    ov = Float3(*(torch.zeros(n_pad) for _ in range(3)))
    lay = lattice_build(X, ov, 0, 1.0, 8, 4, 16)
    lay = lay._replace(T=augment(lay.T, 0, B.precompute),
                       E=augment(lay.E, 0, B.precompute))
    out = lattice_pairwise_plain(B.make_force(B.Params()),
                                 friction_w_neighbour, lay, 0, 1.0,
                                 grid_size=8, capacity=4, z_block=2)
    for part in (out[:4], out[4]):
        F, sum_f, sum_v, aux = part
        for a in (*F, sum_f, *sum_v, *aux.values()):
            assert not a.any()
