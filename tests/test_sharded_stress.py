"""Multi-device stress tier: O(1k) particles, O(100)-step horizons,
migration churn, rebalance-under-flow, deliberate cap overflow, and a
brick-vs-slab-vs-single equivalence run on the virtual 8-device CPU mesh
(SURVEY.md 4.2 — the mpirun-on-localhost analogue; config 5 insurance
so the first real multi-GPU run holds no surprises).

The smoke-scale equivalence tests live in test_sharded.py/test_brick.py;
this file pushes occupancy, migration rates, and in-run rebalancing well
past them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from spherharm_tpu.core.simulation import Simulation
from spherharm_tpu.core.state import SimParams
from spherharm_tpu.models import scenarios, shapes_library
from spherharm_tpu.ops.neighbor import CellGrid
from spherharm_tpu.parallel.brick import BrickSimulation
from spherharm_tpu.parallel.halo import ShardedSimulation

pytestmark = pytest.mark.slow  # minutes-long physics horizons


def _gas(n, box, seed=0, lmax=2, drift=0.0):
    """Dense-ish periodic ellipsoid gas with random velocities."""
    rng = np.random.default_rng(seed)
    shapes = shapes_library.build_shapes(
        [shapes_library.ellipsoid_coeffs(0.55, 0.45, 0.4, lmax)],
        lmax, contact_quad=(6, 12),
    )
    side = int(np.ceil(n ** (1 / 3)))
    pitch = box / side
    pts = []
    for i in range(n):
        cx, cy, cz = i % side, (i // side) % side, i // side**2
        pts.append([(cx + 0.5) * pitch, (cy + 0.5) * pitch,
                    (cz + 0.5) * pitch])
    x = np.asarray(pts) + rng.uniform(-0.06, 0.06, (n, 3)) * pitch
    v = rng.normal(size=(n, 3)) * 0.5
    v[:, 0] += drift
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    params = SimParams.create(
        dt=1e-3, kn=1e4, gamma_n=5.0, mu=0.3, cutoff=1.2, skin=0.3,
    )
    state = scenarios.make_state(x, [0, 0, 0], [box, box, box], v=v, q=q)
    return shapes, params, state


def _by_tag(state, fields=("x", "v")):
    tags = np.asarray(state.tag)
    act = np.asarray(state.active)
    out = {}
    for f in fields:
        arr = np.asarray(getattr(state, f))
        out[f] = {int(t): arr[i] for i, t in enumerate(tags) if act[i]}
    return out


def _single_ref(shapes, params, state0, box, steps, pair_capacity=8192):
    grid = CellGrid([0, 0, 0], [box, box, box], 1.5, (True,) * 3)
    sim = Simulation(
        shapes, params, periodic=(True,) * 3, neighbor_mode="cell",
        grid=grid, k_max=24, cell_cap=16, pair_capacity=pair_capacity,
        conservative=False,
    )
    s, ng = sim.init_neighbors(state0)
    s, ng = sim.run(s, ng, steps)
    assert int(ng.overflow) == 0
    return sim, s, ng


def test_stress_slab_gas_1k():
    """1024 particles on 8 slabs, 160 steps of drifting gas: heavy halo
    traffic + continuous migration churn. Zero overflow, exact tag
    conservation, per-tag trajectory equivalence with single-device."""
    n, box, steps = 1024, 14.0, 160
    shapes, params, state0 = _gas(n, box, seed=3, drift=0.8)

    sim1, s1, _ = _single_ref(shapes, params, state0, box, steps)

    mesh = Mesh(np.array(jax.devices()[:8]), ("x",))
    sim8 = ShardedSimulation(
        shapes, params, mesh=mesh, box_lo=(0, 0, 0),
        box_hi=(box, box, box),
        cap_local=512, halo_cap=512, migrate_cap=128,
        periodic=(True,) * 3, k_max=24, cell_cap=16, pair_capacity=4096,
        conservative=False,
    )
    s8, ng8, gh8 = sim8.init(state0)
    for _ in range(4):
        s8, ng8, gh8 = sim8.run(s8, ng8, gh8, steps // 4)
    assert int(ng8.overflow) == 0, f"overflow={int(ng8.overflow)}"

    tags8 = sorted(
        int(t) for t, a in zip(np.asarray(s8.tag), np.asarray(s8.active))
        if a
    )
    assert tags8 == list(range(1, n + 1))

    a, b = _by_tag(s1), _by_tag(s8)
    assert set(a["x"]) == set(b["x"])
    for t in a["x"]:
        np.testing.assert_allclose(b["x"][t], a["x"][t], atol=8e-3,
                                   err_msg=f"x mismatch tag {t}")
    t8 = sim8.thermo(s8, ng8, gh8)
    assert int(t8["n"]) == n
    assert np.isfinite(float(t8["etot"]))


def test_stress_rebalance_under_flow():
    """rebalance() every block while the gas drifts: bounds keep moving,
    ownership migrates, the trajectory must stay identical to the
    single-device reference (rebalancing is physics-neutral), and no
    capacity overflows. Exercises the deform_min-corrected bin-grid
    legality clamp on every call."""
    n, box, steps_blk, blocks = 512, 14.0, 40, 4
    shapes, params, state0 = _gas(n, box, seed=5, drift=1.2)

    sim1, s1, _ = _single_ref(shapes, params, state0, box,
                              steps_blk * blocks)

    mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    sim4 = ShardedSimulation(
        shapes, params, mesh=mesh, box_lo=(0, 0, 0),
        box_hi=(box, box, box),
        cap_local=512, halo_cap=384, migrate_cap=128,
        periodic=(True,) * 3, k_max=24, cell_cap=16, pair_capacity=4096,
        conservative=False,
    )
    s4, ng4, gh4 = sim4.init(state0)
    fr0 = np.asarray(jax.device_get(gh4.fracs))
    moved = False
    for _ in range(blocks):
        s4, ng4, gh4 = sim4.run(s4, ng4, gh4, steps_blk)
        s4, ng4, gh4 = sim4.rebalance(s4, ng4, gh4)
        moved = moved or not np.allclose(
            fr0, np.asarray(jax.device_get(gh4.fracs))
        )
    assert moved, "rebalance never moved any boundary"
    assert int(ng4.overflow) == 0, f"overflow={int(ng4.overflow)}"

    a, b = _by_tag(s1), _by_tag(s4)
    assert set(a["x"]) == set(b["x"])
    for t in a["x"]:
        np.testing.assert_allclose(b["x"][t], a["x"][t], atol=8e-3,
                                   err_msg=f"x mismatch tag {t}")


def test_migrate_cap_overflow_flags_loudly():
    """A deliberately starved migrate_cap must FIRE the overflow channel
    (gated: nonzero means truncated physics), not silently drop
    particles."""
    n, box = 256, 12.0
    shapes, params, state0 = _gas(n, box, seed=7, drift=3.0)
    mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    sim = ShardedSimulation(
        shapes, params, mesh=mesh, box_lo=(0, 0, 0),
        box_hi=(box, box, box),
        cap_local=256, halo_cap=256, migrate_cap=1,
        periodic=(True,) * 3, k_max=24, cell_cap=16, pair_capacity=2048,
        conservative=False,
    )
    s, ng, gh = sim.init(state0)
    for _ in range(4):
        s, ng, gh = sim.run(s, ng, gh, 40)
    assert int(ng.overflow) != 0, (
        "starved migrate_cap did not flag through the overflow channel"
    )


def test_brick_vs_slab_vs_single_long_horizon():
    """One gas, three decompositions (single / 8-slab / 2x2x2 brick),
    200 steps: identical per-tag trajectories within f32 tolerance and
    zero overflow everywhere."""
    n, box, steps = 512, 12.0, 200
    shapes, params, state0 = _gas(n, box, seed=11, drift=0.5)

    sim1, s1, _ = _single_ref(shapes, params, state0, box, steps)

    mesh_s = Mesh(np.array(jax.devices()[:8]), ("x",))
    sim_s = ShardedSimulation(
        shapes, params, mesh=mesh_s, box_lo=(0, 0, 0),
        box_hi=(box, box, box),
        cap_local=384, halo_cap=384, migrate_cap=96,
        periodic=(True,) * 3, k_max=24, cell_cap=16, pair_capacity=2048,
        conservative=False,
    )
    ss, ngs, ghs = sim_s.init(state0)
    ss, ngs, ghs = sim_s.run(ss, ngs, ghs, steps)
    assert int(ngs.overflow) == 0

    mesh_b = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
                  ("x", "y", "z"))
    sim_b = BrickSimulation(
        shapes, params, mesh=mesh_b, box_lo=(0, 0, 0),
        box_hi=(box, box, box),
        cap_local=384, halo_cap=256, migrate_cap=96,
        periodic=(True,) * 3, k_max=24, cell_cap=16, pair_capacity=2048,
        conservative=False,
    )
    sb, ngb, ghb = sim_b.init(state0)
    sb, ngb, ghb = sim_b.run(sb, ngb, ghb, steps)
    assert int(ngb.overflow) == 0

    ref = _by_tag(s1)
    for name, st in (("slab", ss), ("brick", sb)):
        got = _by_tag(st)
        assert set(got["x"]) == set(ref["x"]), f"{name}: tag set differs"
        for t in ref["x"]:
            np.testing.assert_allclose(
                got["x"][t], ref["x"][t], atol=8e-3,
                err_msg=f"{name}: x mismatch tag {t}",
            )
