"""yalla_tpu_torch against yalla_tpu: the lattice build with mover routing
and thin x-cubes, slot-space rebinning (``lattice_rebin``) and the rebin
cadences of ``lattice_heun_steps`` (per chunk, per step, per pass).

The same numpy inputs (made from a seed) go to both packages.
Tolerances: layouts (``pid``, ``slot_of``, the channels, the extras,
``epid``) and their counts exact -- building and rebinning only move data;
trajectories within atol 1e-5 over 8 steps (as tests/test_fastpath.py
holds its cadences against each other); every ``__err_*`` flag exact.
The JAX side runs its XLA pass (``pallas=False``) where there are no
overflow extras, its Pallas kernel in interpret mode where there are.

``relu_force`` and ``friction_w_neighbour`` jump at dist 1 (by 0.2 and
by one neighbour's weight): a pair that reaches dist 1 within f32
rounding on one side in one package and on the other in the other parts
the trajectories by about ``0.2 dt`` a step.  The seeded states here have
no such pair in their steps.

Mirrors tests/test_fastpath.py's three rebin tests and
tests/test_extras.py's route-mask build.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yalla_tpu import dtypes as jdt
from yalla_tpu.inits import relu_force as j_relu
from yalla_tpu.ops import lattice_xla as JL
from yalla_tpu.ops.common import friction_w_neighbour as j_friction
from yalla_tpu_torch import dtypes as tdt
from yalla_tpu_torch.inits import relu_force as t_relu
from yalla_tpu_torch.ops import lattice_xla as TL
from yalla_tpu_torch.ops.common import friction_w_neighbour as t_friction

torch.set_num_threads(2)

ATOL = 1e-5


# ---- helpers shared by test_torch_resident.py and test_torch_xsplit.py ----

def both_states(pos, vel=None):
    """The same f32 positions (and old_v, zero by default) as a JAX and a
    port ``Float3`` pair: ``((jX, jov), (tX, tov))``."""
    pos = np.asarray(pos, np.float32)
    vel = np.zeros_like(pos) if vel is None else np.asarray(vel, np.float32)

    def j(a):
        return jdt.Float3(*(jnp.asarray(a[:, k]) for k in range(3)))

    def t(a):
        return tdt.Float3(*(torch.tensor(a[:, k]) for k in range(3)))
    return (j(pos), j(vel)), (t(pos), t(vel))


def run_both(n_steps, rebuild_every, forces, state, n, dt, cube, *,
             fix_mode="com", grid=8, capacity=8, z_block=2, fix_point=0,
             force_r_max=None, extras_cap=0, extras_block_cap=16,
             rebin_m_cap=0, rebin_per_pass=False, route_movers=0.0,
             x_split=1, gens=(None, None), gen_args=(None, None)):
    """``lattice_heun_steps`` of both packages on ``state``: the JAX one on
    its XLA pass without extras and its Pallas kernel (interpret mode)
    with them.  ``forces``: (JAX force, port force).  Returns (JAX
    output, port output)."""
    (jX, jov), (tX, tov) = state
    jout = JL.lattice_heun_steps(
        n_steps, rebuild_every, forces[0], j_friction, fix_mode, grid,
        capacity, z_block, jX, jov, jnp.int32(n), jnp.float32(dt),
        jnp.float32(cube), jnp.int32(fix_point), None, bool(extras_cap),
        gens[0], gen_args[0],
        None if force_r_max is None else jnp.float32(force_r_max),
        extras_cap, extras_block_cap, rebin_m_cap, rebin_per_pass,
        route_movers, x_split)
    tout = TL.lattice_heun_steps(
        n_steps, rebuild_every, forces[1], t_friction, fix_mode, grid,
        capacity, z_block, tX, tov, n, dt, cube, fix_point, None, True,
        gens[1], gen_args[1], force_r_max, extras_cap, extras_block_cap,
        rebin_m_cap, rebin_per_pass, route_movers, x_split)
    return jax.block_until_ready(jout), tout


RELU = (j_relu, t_relu)


def flags(aux):
    """Every ``__err_*`` flag and staleness measure as a float."""
    return {k: float(np.max(np.asarray(v))) for k, v in aux.items()
            if k.startswith("__err_") or k.startswith("stale_")}


def assert_same_run(jout, tout, n, atol=ATOL, trajectories=True):
    """Positions and old_v within ``atol`` on the first ``n`` rows (unless
    ``trajectories`` is False), the same aux keys, every flag equal, the
    staleness measures within ``atol``."""
    for name, js, ts in (("X", jout[0], tout[0]), ("old_v", jout[1],
                                                   tout[1]))[
            :2 if trajectories else 0]:
        for f, a, b in zip(js._fields, js, ts):
            np.testing.assert_allclose(b.numpy()[:n], np.asarray(a)[:n],
                                       rtol=0, atol=atol,
                                       err_msg=f"{name}.{f}")
    assert set(tout[2]) == set(jout[2])
    jf, tf = flags(jout[2]), flags(tout[2])
    for k in jf:
        if k.startswith("__err_"):
            assert tf[k] == jf[k], (k, tf[k], jf[k])
        else:
            assert abs(tf[k] - jf[k]) <= atol, (k, tf[k], jf[k])
    return tf


def assert_clean(f):
    bad = {k: v for k, v in f.items() if k.startswith("__err_") and v}
    assert not bad, bad


def same_layout(tlay, jlay):
    """Every field of two layouts equal (``None`` where both have none)."""
    for name in JL.LatticeLayout._fields:
        a, b = getattr(tlay, name), getattr(jlay, name)
        if b is None:
            assert a is None, name
        elif hasattr(b, "_fields"):
            for f, x, y in zip(b._fields, a, b):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                              err_msg=f"{name}.{f}")
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)


# ---- the build with route_mask and x_split --------------------------------

def _clumped(n, n_pad, seed=3):
    """tests/test_extras.py ``_clumped_state``: a tight clump plus
    scattered cells."""
    rng = np.random.default_rng(seed)
    pos = np.concatenate([rng.uniform(-0.45, 0.45, (n // 4, 3)),
                          rng.uniform(-5.5, 5.5, (n - n // 4, 3)),
                          np.zeros((n_pad - n, 3))])
    return pos.astype(np.float32)


# (grid, capacity, extras_cap, routed rows, x_split)
BUILDS = {"route": (32, 8, 64, [3, 40, 77], 1),
          "route_spill": (16, 2, 128, [0, 5, 50, 90], 1),
          "x_split2": ((32, 16, 16), 2, 128, None, 2),
          "x_split3_no_extras": ((48, 16, 16), 4, 0, None, 3),
          "route_x_split2": ((32, 16, 16), 4, 64, [1, 2, 60], 2)}


@pytest.mark.parametrize("case", list(BUILDS))
def test_torch_build_route_and_x_split_match_jax(case):
    """``lattice_build`` with ``route_mask`` and ``x_split``: the same
    layout as the JAX package's, field for field; routed cells hold no
    slot and sit in the extras list (tests/test_extras.py's
    route-mask build), every active cell exactly once."""
    grid, C, extras, routed, xs = BUILDS[case]
    n, n_pad = 96, 128
    (jX, jov), (tX, tov) = both_states(_clumped(n, n_pad))
    mask = np.zeros(n_pad, bool)
    if routed:
        mask[routed] = True
    kw = dict(route_mask=None if routed is None else torch.tensor(mask),
              x_split=xs)
    tlay = TL.lattice_build(tX, tov, n, 1.0, grid, C, extras, **kw)
    jlay = JL.lattice_build(jX, jov, jnp.int32(n), jnp.float32(1.0), grid, C,
                            extras, route_mask=None if routed is None
                            else jnp.asarray(mask), x_split=xs)
    same_layout(tlay, jlay)
    n_slots = tlay.pid.shape[0]
    in_slot = tlay.slot_of.numpy()[:n] < n_slots
    in_extras = np.isin(np.arange(n), tlay.epid.numpy()) if extras \
        else np.zeros(n, bool)
    assert int(tlay.n_dropped) == 0
    assert np.all(in_slot | in_extras) and not np.any(in_slot & in_extras)
    for i in routed or ():
        assert in_extras[i] and not in_slot[i], i


def test_torch_build_refuses_route_mask_without_extras():
    (_, _), (tX, tov) = both_states(_clumped(96, 128))
    with pytest.raises(ValueError, match="route_mask"):
        TL.lattice_build(tX, tov, 96, 1.0, 32, 8, 0,
                         route_mask=torch.zeros(128, dtype=torch.bool))


# ---- lattice_rebin, layout for layout -------------------------------------

# (grid, capacity, extras_cap, m_cap, with carry, x_split)
REBINS = {"movers": (8, 8, 0, 4096, False, 1),
          "mover_list_overflow": (8, 8, 0, 16, False, 1),
          "extras_spill": (8, 2, 512, 4096, False, 1),
          "extras_drop": (8, 2, 8, 4096, False, 1),
          "carry": (8, 2, 512, 4096, True, 1),
          "carry_no_extras": (8, 8, 0, 4096, True, 1),
          "x_split2": ((16, 8, 8), 2, 512, 4096, True, 2)}


@pytest.mark.parametrize("case", list(REBINS))
def test_torch_rebin_matches_jax(case):
    """``lattice_rebin`` after every slot moved by up to 0.6 per axis:
    the same ``pid``, ``slot_of``, channels, extras, ``epid``, carry and
    counts (``n_dropped``, ``n_oob``, ``n_extras``, ``n_unrebinned``) as
    the JAX function, on a build both packages made equal."""
    grid, C, extras, m_cap, with_carry, xs = REBINS[case]
    rng = np.random.default_rng(11)
    n, n_pad = 400, 512
    pos = rng.uniform(-3.9, 3.9, (n_pad, 3)).astype(np.float32)
    (jX, jov), (tX, tov) = both_states(pos, rng.normal(size=(n_pad, 3)))
    tlay = TL.lattice_build(tX, tov, n, 1.0, grid, C, extras, x_split=xs)
    jlay = JL.lattice_build(jX, jov, jnp.int32(n), jnp.float32(1.0), grid, C,
                            extras, x_split=xs)
    same_layout(tlay, jlay)
    n_slots = tlay.pid.shape[0]

    def moved(P, size, seed):
        d = np.random.default_rng(seed).uniform(-0.6, 0.6, (3, size)) \
            .astype(np.float32)
        p = [np.asarray(a) + d[k] for k, a in enumerate(P)]
        return (jdt.Float3(*(jnp.asarray(a) for a in p)),
                tdt.Float3(*(torch.tensor(a) for a in p)))
    jT, tT = moved(jlay.T, n_slots, 1)
    jlay, tlay = jlay._replace(T=jT), tlay._replace(T=tT)
    jc = tc = jcE = tcE = None
    if extras:
        jE, tE = moved(jlay.E, extras, 2)
        jlay, tlay = jlay._replace(E=jE), tlay._replace(E=tE)
    if with_carry:
        jc, tc = moved((np.zeros(n_slots),) * 3, n_slots, 3)
        if extras:
            jcE, tcE = moved((np.zeros(extras),) * 3, extras, 4)
    jout = JL.lattice_rebin(jlay, jnp.float32(1.0), grid, C, m_cap, extras,
                            jc, jcE, x_split=xs)
    tout = TL.lattice_rebin(tlay, 1.0, grid, C, m_cap, extras, tc, tcE,
                            x_split=xs)
    assert len(tout) == len(jout)
    same_layout(tout[0], jout[0])
    assert int(tout[1]) == int(jout[1])
    for tcar, jcar in zip(tout[2:], jout[2:]):
        for a, b in zip(tcar, jcar):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    lay = tout[0]
    # each case reaches the branch it names
    if case == "mover_list_overflow":
        assert int(tout[1]) > 0
    else:
        assert int(tout[1]) == 0
    if case == "extras_drop":
        assert int(lay.n_dropped) > 0
    if case in ("extras_spill", "carry", "x_split2"):
        assert int(lay.n_extras) > 0 and int(lay.n_dropped) == 0


# ---- the rebin cadences of lattice_heun_steps ------------------------------

def _uniform_state(seed=0, n=1200, n_pad=1280, half=4.0):
    """tests/test_fastpath.py's rebin state: cells uniform in a cube."""
    rng = np.random.default_rng(seed)
    return n, both_states(rng.uniform(-half, half, (n_pad, 3)))


# tests/test_fastpath.py's cadences at grid 8 (cube 1.2 covers +-4.8)
CADENCE = dict(grid=8, capacity=16, z_block=2, force_r_max=1.0)


@pytest.mark.parametrize("rebuild_every", [4, 1])
def test_torch_rebin_chunks_match_jax(rebuild_every):
    """``rebin_m_cap > 0`` per chunk (``rebuild_every`` 4) and per step
    (1): the JAX trajectory and flags, and the port's stable-resident
    chunk path (tests/test_fastpath.py
    ``test_rebin_resident_matches_stable_resident``) within 1e-5."""
    n, state = _uniform_state()
    jout, tout = run_both(8, rebuild_every, RELU, state, n, 0.01, 1.2,
                          rebin_m_cap=2048, **CADENCE)
    assert_clean(assert_same_run(jout, tout, n))
    ref = TL.lattice_heun_steps(8, 4, t_relu, t_friction, "com", 8, 16, 2,
                                *state[1], n, 0.01, 1.2, 0, None, True, None,
                                None, 1.0)
    for a, b in zip(tout[0], ref[0]):
        assert float((a - b).abs()[:n].max()) < 1e-5


def test_torch_rebin_per_pass_matches_jax():
    """``rebin_per_pass``: the binning re-derived before every pass, the
    predictor derivative carried through the rebin -- the JAX trajectory
    and flags, and the port's per-pass rebuild within 1e-5 (tests/
    test_fastpath.py ``test_rebin_per_pass_matches_per_pass_build``)."""
    n, state = _uniform_state()
    kw = dict(CADENCE, force_r_max=None)
    jout, tout = run_both(8, 1, RELU, state, n, 0.01, 1.2,
                          rebin_m_cap=2048, rebin_per_pass=True, **kw)
    assert_clean(assert_same_run(jout, tout, n))
    ref = TL.lattice_heun_steps(8, 1, t_relu, t_friction, "com", 8, 16, 2,
                                *state[1], n, 0.01, 1.2, 0)
    for a, b in zip(list(tout[0]) + list(tout[1]),
                    list(ref[0]) + list(ref[1])):
        assert float((a - b).abs()[:n].max()) < 1e-5


def spilling_state(seed=0, n=600, n_pad=640, n_clump=20):
    """Cells uniform over x in +-8, y and z in +-4.4 with a clump of
    ``n_clump`` (sigma 0.5) at the origin that spills a few cells past
    capacity 4 at cube 1.2 (7 at seed 0): the grid (32, 8, 8) at C 4 is
    the JAX kernel's smallest row of 128 slots."""
    rng = np.random.default_rng(seed)
    pos = np.concatenate([
        rng.uniform(-1, 1, (n_pad - n_clump, 3)) * [8.0, 4.4, 4.4],
        rng.normal(0, 0.5, (n_clump, 3))])
    rng.shuffle(pos)
    return n, both_states(pos)


def test_torch_rebin_per_pass_with_extras_matches_jax():
    """Per-pass rebin with overflow extras (tests/test_fastpath.py
    ``test_rebin_per_pass_with_extras_matches``): cells spilling a full
    cube ride the side list -- the JAX trajectory (its kernel in
    interpret mode) and flags, and the port's per-pass rebuild with
    extras."""
    n, state = spilling_state()
    kw = dict(grid=(32, 8, 8), capacity=4, z_block=2, extras_cap=256,
              extras_block_cap=8)
    jout, tout = run_both(6, 1, RELU, state, n, 0.01, 1.2, rebin_m_cap=2048,
                          rebin_per_pass=True, **kw)
    assert_clean(assert_same_run(jout, tout, n))
    ref = TL.lattice_heun_steps(6, 1, t_relu, t_friction, "com", (32, 8, 8),
                                4, 2, *state[1], n, 0.01, 1.2, 0, None, True,
                                None, None, None, 256, 8)
    for a, b in zip(tout[0], ref[0]):
        assert float((a - b).abs()[:n].max()) < 1e-5
