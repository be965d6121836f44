"""Wall contacts: equilibrium rest depth + bounce (SURVEY.md 2 B.5)."""

import jax.numpy as jnp
import numpy as np
import pytest

from spherharm_tpu.core.simulation import Simulation
from spherharm_tpu.core.state import SimParams
from spherharm_tpu.models import scenarios, shapes_library
from spherharm_tpu.ops.walls import CylinderWall, PlaneWall


def _dropped_sphere(gamma_n=200.0, kn=1e5, R=0.5, h=0.6, mu=0.0):
    lmax = 0
    shapes = shapes_library.build_shapes(
        [shapes_library.sphere_coeffs(R, lmax)], lmax, contact_quad=(12, 24)
    )
    params = SimParams.create(
        dt=1e-4, kn=kn, gamma_n=gamma_n, mu=mu,
        gravity=(0.0, 0.0, -10.0), cutoff=2 * R, skin=0.2 * R,
    )
    state = scenarios.make_state(
        [[0.0, 0.0, h]], [-2, -2, 0], [2, 2, 4],
    )
    walls = (PlaneWall.create((0, 0, 0), (0, 0, 1)),)
    sim = Simulation(shapes, params, neighbor_mode="static", k_max=1, conservative=False,
                     walls=walls)
    state, neigh = sim.init_neighbors(state)
    return sim, state, neigh


def test_sphere_settles_to_hertz_equilibrium():
    R, kn = 0.5, 1e5
    sim, state, neigh = _dropped_sphere(gamma_n=500.0, kn=kn, R=R)
    state, neigh = sim.run(state, neigh, 20000)
    m = float(sim.shapes.mass_of(state.shtype, state.scale)[0])
    # Equilibrium: kn*sqrt(R)*delta^{3/2} = m g
    delta_eq = (m * 10.0 / (kn * np.sqrt(R))) ** (2 / 3)
    z = float(state.x[0, 2])
    assert z == pytest.approx(R - delta_eq, abs=0.15 * delta_eq + 1e-4)
    assert abs(float(state.v[0, 2])) < 1e-3


def test_bounce_restitution_below_one():
    sim, state, neigh = _dropped_sphere(gamma_n=100.0, h=1.0)
    zs = []
    for _ in range(40):
        state, neigh = sim.run(state, neigh, 200)
        zs.append(float(state.x[0, 2]))
    peak = max(zs[5:])  # apex after first bounce
    assert peak < 1.0  # lost energy
    assert peak > 0.5  # but bounced


@pytest.mark.slow
def test_cylinder_wall_confines():
    lmax = 0
    R_p, R_c = 0.3, 2.0
    shapes = shapes_library.build_shapes(
        [shapes_library.sphere_coeffs(R_p, lmax)], lmax, contact_quad=(10, 20)
    )
    params = SimParams.create(
        dt=1e-4, kn=1e5, gamma_n=300.0, mu=0.3,
        gravity=(0.0, 0.0, -10.0), cutoff=2 * R_p, skin=0.1 * R_p,
    )
    state = scenarios.make_state(
        [[0.5, 0.0, 0.5]], [-3, -3, -3], [3, 3, 3],
        v=[[1.5, 0.0, 0.0]],
    )
    walls = (CylinderWall.create((0, 0, 0), (0, 1, 0), R_c, omega=0.0),)
    sim = Simulation(shapes, params, neighbor_mode="static", k_max=1, conservative=False,
                     walls=walls)
    state, neigh = sim.init_neighbors(state)
    # A frictional sphere rolling inside a cylinder has near-zero
    # contact-point slip, so sliding friction barely dissipates once it
    # rolls without slipping: the mechanical energy above the resting
    # point decays 23.1 -> ~4 in the first 120k steps and then PLATEAUS
    # (measured block-by-block; only normal damping on the small radial
    # velocity keeps bleeding, at a negligible rate). Full settling
    # needs rolling resistance (tested separately). Assert confinement
    # plus the >70% energy decay the physics actually gives.
    z_bot = -(R_c - R_p)
    e0 = 0.5 * 1.5**2 + 10.0 * (0.5 - z_bot)   # 23.1
    for _ in range(6):
        state, neigh = sim.run(state, neigh, 20000)
        v = float(jnp.linalg.norm(state.v[0]))
        z = float(state.x[0, 2])
        e = 0.5 * v * v + 10.0 * (z - z_bot)
        if e < 0.25 * e0:
            break
    x = np.asarray(state.x[0])
    rad = np.hypot(x[0], x[2])
    assert rad <= R_c - R_p * 0.8      # confined inside the shell
    assert e < 0.25 * e0               # most energy dissipated (meas. ~4)


def test_rolling_resistance_decelerates_rolling_sphere():
    """A sphere rolling without slip on a plane coasts forever under
    pure sliding friction (zero contact-point slip); with the
    spring-dashpot-slider rolling model it must decelerate."""
    R, v0 = 0.5, 1.0
    lmax = 0
    shapes = shapes_library.build_shapes(
        [shapes_library.sphere_coeffs(R, lmax)], lmax, contact_quad=(10, 20)
    )

    def run(k_roll, gamma_roll, mu_roll):
        params = SimParams.create(
            dt=1e-4, kn=1e5, gamma_n=300.0, mu=0.5,
            k_roll=k_roll, gamma_roll=gamma_roll, mu_roll=mu_roll,
            gravity=(0.0, 0.0, -10.0), cutoff=2 * R, skin=0.2 * R,
        )
        # Start resting on the plane, rolling without slip: v = omega x R.
        m = float(shapes.mass_of(jnp.zeros(1, jnp.int32), jnp.ones(1))[0])
        inertia = float(shapes.inertia_of(
            jnp.zeros(1, jnp.int32), jnp.ones(1))[0, 0])
        omega_y = v0 / R  # zero contact-point slip: v_cp = v - omega_y R
        state = scenarios.make_state(
            [[0.0, 0.0, R * 0.999]], [-50, -2, 0], [50, 2, 4],
            v=[[v0, 0.0, 0.0]],
            angmom=[[0.0, inertia * omega_y, 0.0]],
        )
        walls = (PlaneWall.create((0, 0, 0), (0, 0, 1)),)
        sim = Simulation(shapes, params, neighbor_mode="static", k_max=1, conservative=False,
                         walls=walls)
        state, neigh = sim.init_neighbors(state)
        state, neigh = sim.run(state, neigh, 20000)
        return float(state.v[0, 0])

    vx_off = run(0.0, 0.0, 0.0)
    vx_on = run(2e4, 20.0, 0.3)
    assert vx_off > 0.9 * v0          # pure sliding friction: coasts
    assert vx_on < 0.5 * vx_off       # rolling resistance: decelerates


@pytest.mark.slow
def test_cylinder_settles_with_rolling_resistance():
    """With the rolling model on, the sphere in the cylinder shell damps
    to near-rest at the bottom — the behavior the plain-friction variant
    above physically cannot reach (energy plateaus at ~4)."""
    lmax = 0
    R_p, R_c = 0.3, 2.0
    shapes = shapes_library.build_shapes(
        [shapes_library.sphere_coeffs(R_p, lmax)], lmax, contact_quad=(10, 20)
    )
    params = SimParams.create(
        dt=1e-4, kn=1e5, gamma_n=300.0, mu=0.3,
        k_roll=2e4, gamma_roll=20.0, mu_roll=0.3,
        gravity=(0.0, 0.0, -10.0), cutoff=2 * R_p, skin=0.1 * R_p,
    )
    state = scenarios.make_state(
        [[0.5, 0.0, 0.5]], [-3, -3, -3], [3, 3, 3],
        v=[[1.5, 0.0, 0.0]],
    )
    walls = (CylinderWall.create((0, 0, 0), (0, 1, 0), R_c, omega=0.0),)
    sim = Simulation(shapes, params, neighbor_mode="static", k_max=1, conservative=False,
                     walls=walls)
    state, neigh = sim.init_neighbors(state)
    z_bot = -(R_c - R_p)
    for _ in range(8):
        state, neigh = sim.run(state, neigh, 20000)
        v = float(jnp.linalg.norm(state.v[0]))
        z = float(state.x[0, 2])
        e = 0.5 * v * v + 10.0 * (z - z_bot)
        if e < 0.02:
            break
    x = np.asarray(state.x[0])
    assert e < 0.02                       # truly settled
    assert x[2] == pytest.approx(z_bot, abs=0.2 * R_p)


def test_rotating_drum_drags_particle():
    """Friction from a spinning drum wall should torque a resting sphere."""
    lmax = 0
    R_p, R_c = 0.3, 2.0
    shapes = shapes_library.build_shapes(
        [shapes_library.sphere_coeffs(R_p, lmax)], lmax, contact_quad=(10, 20)
    )
    params = SimParams.create(
        dt=1e-4, kn=1e5, gamma_n=300.0, gamma_t=300.0, mu=0.5,
        gravity=(0.0, 0.0, -10.0), cutoff=2 * R_p, skin=0.1 * R_p,
    )
    state = scenarios.make_state(
        [[0.0, 0.0, -(R_c - R_p) + 0.01]], [-3, -3, -3], [3, 3, 3],
    )
    walls = (CylinderWall.create((0, 0, 0), (0, 1, 0), R_c, omega=0.5),)
    sim = Simulation(shapes, params, neighbor_mode="static", k_max=1, conservative=False,
                     walls=walls)
    state, neigh = sim.init_neighbors(state)
    state, neigh = sim.run(state, neigh, 5000)
    # Drum spins about +y; wall surface at bottom moves in -x... the
    # particle should be dragged sideways and start spinning about y.
    assert abs(float(state.x[0, 0])) > 0.01
    assert abs(float(state.angmom[0, 1])) > 1e-5


def _wall_system(seed=0, n=48, lmax=4):
    rng = np.random.default_rng(seed)
    shapes = shapes_library.build_shapes(
        [shapes_library.blob_coeffs(lmax, seed=seed + t, mean_radius=0.5,
                                    roughness=0.12) for t in range(2)],
        lmax, contact_quad=(8, 16),
    )
    params = SimParams.create(dt=1e-4, kn=1e5, gamma_n=20.0, mu=0.4,
                              k_roll=2e4, gamma_roll=10.0, mu_roll=0.2,
                              cutoff=1.4, skin=0.2)
    # Positions straddling z=0.5: some through the wall, some near, some
    # far (broad-phase cull exercised).
    x = rng.uniform(0.8, 5.2, (n, 3))
    x[:, 2] = rng.uniform(0.25, 1.6, n)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    state = scenarios.make_state(
        x, [0, 0, 0], [6, 6, 6], q=q,
        v=rng.normal(size=(n, 3)) * 0.3,
        angmom=rng.normal(size=(n, 3)) * 0.05,
        scale=rng.uniform(0.85, 1.15, n),
        shtype=rng.integers(0, 2, n),
    )
    hist = jnp.asarray(rng.normal(size=(n, 6)) * 1e-4, jnp.float32)
    return shapes, params, state, hist


def test_per_wall_material_override():
    """A wall.mat row must act exactly like the same values as globals,
    and differ from the global run."""
    from spherharm_tpu.ops import walls as walls_mod

    shapes, params, state, hist = _wall_system(seed=6)
    soft = [2e4, 8e3, 10.0, 5.0, 0.2, 0.0, 0.0, 0.0]
    wall_soft = PlaneWall.create([0.0, 0.0, 0.5], [0.0, 0.0, 1.0], mat=soft)
    wall_plain = PlaneWall.create([0.0, 0.0, 0.5], [0, 0, 1.0])
    params_soft = SimParams.create(
        dt=1e-4, kn=soft[0], kt=soft[1], gamma_n=soft[2], gamma_t=soft[3],
        mu=soft[4], cutoff=1.4, skin=0.2,
    )
    f_ref, t_ref, h_ref, pe_ref, _ = walls_mod.wall_contact(
        state, shapes, params_soft, wall_plain, hist, exact=True,
    )
    f, t, h, pe, _ = walls_mod.wall_contact(
        state, shapes, params, wall_soft, hist, exact=True,
    )
    fmag = max(float(np.abs(np.asarray(f_ref)).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(f), np.asarray(f_ref),
                               atol=2e-3 * fmag)
    np.testing.assert_allclose(np.asarray(t), np.asarray(t_ref),
                               atol=2e-3 * fmag)
    # Sanity: the override differs from the global-params wall.
    f_g, *_ = walls_mod.wall_contact(
        state, shapes, params, wall_plain, hist, exact=True,
    )
    assert not np.allclose(np.asarray(f_g), np.asarray(f_ref),
                           atol=1e-3 * fmag)


def test_deck_wall_coeff():
    from spherharm_tpu.io.deck import DeckRunner

    deck = """
units lj
boundary f f f
region box block -2 2 -2 2 0 4
create_box 1 box
shape 1 sphere 0.5
pair_style spherharm 100000 28571 0 0 0
timestep 2e-4
create_atoms 1 single 0 0 0.45
fix 1 all nve/sh
fix 2 all wall/gran plane 0 0 0 0 0 1 coeff 30000 8571 0 0 0
run 10
"""
    runner = DeckRunner().run_text(deck)
    w = runner.sim.walls[0]
    assert w.mat is not None
    assert float(w.mat[0]) == pytest.approx(30000.0)
    v = np.asarray(runner.state.v)[np.asarray(runner.state.active)]
    assert v[0, 2] > 0  # pushed off the floor
