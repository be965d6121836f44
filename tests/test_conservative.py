"""Conservative (autodiff-gradient) elastic mode: energy across an
undamped aspherical collision (the Lmax=8 drift-metric fix; see
scripts/conservative_probe.py)."""

import numpy as np
import pytest

from spherharm_tpu.core.simulation import Simulation
from spherharm_tpu.core.state import SimParams
from spherharm_tpu.models import scenarios, shapes_library


def _collide(conservative: bool, n_steps=24000, dt=2.5e-5, lmax=6):
    rng = np.random.default_rng(2)
    coeffs = [
        shapes_library.blob_coeffs(lmax, seed=s, mean_radius=0.5,
                                   roughness=0.12)
        for s in (3, 5)
    ]
    shapes = shapes_library.build_shapes(coeffs, lmax,
                                         contact_quad=(10, 20))
    params = SimParams.create(dt=dt, kn=1e5, gamma_n=0.0, mu=0.0,
                              skin=0.2, cutoff=1.4)
    q = rng.normal(size=(2, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    state = scenarios.make_state(
        [[-0.75, 0.02, -0.03], [0.75, 0.0, 0.0]],
        [-4, -4, -4], [4, 4, 4], q=q,
        v=[[0.5, 0.0, 0.0], [-0.5, 0.0, 0.0]],
        shtype=[0, 1],
    )
    sim = Simulation(shapes, params, neighbor_mode="allpairs", k_max=1,
                     conservative=conservative)
    state, neigh = sim.init_neighbors(state)
    e0 = float(sim.thermo(state, neigh)["etot"])
    state, neigh = sim.run(state, neigh, n_steps)
    t = sim.thermo(state, neigh)
    assert float(t["pe_pair"]) == 0.0, "collision not finished"
    # The bounce actually happened (velocities changed direction/mix).
    assert float(state.v[0, 0]) < 0.45
    return (float(t["etot"]) - e0) / e0


@pytest.mark.slow
def test_conservative_mode_conserves_where_geometric_leaks():
    err_geom = _collide(conservative=False)
    err_auto = _collide(conservative=True)
    # Expected scale (f32, dt=2.5e-5): geom ~-3.6e-3, auto ~-1.5e-4.
    assert abs(err_geom) > 1e-3      # the leak this mode exists to fix
    assert abs(err_auto) < 6e-4      # integrator-limited
    assert abs(err_auto) < 0.25 * abs(err_geom)


@pytest.mark.slow
def test_sharded_conservative_compiles_and_runs():
    """ShardedSimulation(conservative=True): vjp under shard_map must
    compile and stay finite (the sharded accuracy mode)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from spherharm_tpu.parallel.halo import ShardedSimulation

    lmax = 2
    rng = np.random.default_rng(4)
    shapes = shapes_library.build_shapes(
        [shapes_library.ellipsoid_coeffs(0.55, 0.45, 0.4, lmax)],
        lmax, contact_quad=(6, 12),
    )
    box = 8.0
    n = 48
    x = rng.uniform(0.5, box - 0.5, (n, 3))
    v = rng.normal(size=(n, 3)) * 0.4
    params = SimParams.create(dt=1e-3, kn=1e4, gamma_n=5.0, mu=0.3,
                              cutoff=1.2, skin=0.3)
    state = scenarios.make_state(x, [0, 0, 0], [box] * 3, v=v)
    mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
    sim = ShardedSimulation(
        shapes, params, mesh=mesh, box_lo=(0, 0, 0),
        box_hi=(box, box, box), cap_local=64, halo_cap=48,
        migrate_cap=24, periodic=(True, True, True), k_max=16,
        cell_cap=10, pair_capacity=384, conservative=True,
    )
    s, ng, gh = sim.init(state)
    s, ng, gh = sim.run(s, ng, gh, 50)
    t = sim.thermo(s, ng, gh)
    assert np.isfinite(float(t["etot"]))
    assert int(t["n"]) == n
