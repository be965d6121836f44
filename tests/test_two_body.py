"""Config 1 acceptance (BASELINE.json:7): two Lmax=0 sphere-degenerate SH
particles, head-on NVE collision with Hertzian normal contact —
restitution + energy conservation (SURVEY.md section 4.3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spherharm_tpu.models import scenarios


def total_momentum(state, sim):
    m = sim.shapes.mass_of(state.shtype, state.scale)
    return np.asarray(jnp.sum(m[:, None] * state.v, axis=0))


def total_angular_momentum(state, sim):
    m = sim.shapes.mass_of(state.shtype, state.scale)
    orbital = jnp.sum(m[:, None] * jnp.cross(state.x, state.v), axis=0)
    return np.asarray(orbital + jnp.sum(state.angmom, axis=0))


def test_static_hertz_force():
    """Quadrature contact force matches the analytic Hertz law."""
    sim, state, neigh = scenarios.two_body_collision(gamma_n=0.0)
    R, kn = 0.5, 1e5
    for delta in (0.005, 0.01, 0.02, 0.05):
        x = jnp.asarray(
            [[-(R - delta / 2), 0, 0], [R - delta / 2, 0, 0]], jnp.float32
        )
        st = state.replace(x=x, v=jnp.zeros_like(state.v))
        st, ng = sim.init_neighbors(st)
        st, _, _ = sim.compute_forces(st, ng)
        f = np.asarray(st.f)
        expect = kn * np.sqrt(R / 2) * delta**1.5
        assert abs(f[0, 0]) == pytest.approx(expect, rel=0.12)
        # Newton's 3rd law to 1e-6 of the force; the exactly-zero
        # transverse components carry only roundoff (~1e-17).
        np.testing.assert_allclose(f[0], -f[1], rtol=1e-6,
                                   atol=1e-6 * abs(f[0, 0]))


# Energy tolerances per elastic mode, from a dt sweep
# (2e-4/1e-4/5e-5):
#   geometric (conservative=False): for Lmax=0 spheres the geometric
#     assembly IS the exact radial gradient of the Hertz potential —
#     measured |rel err| <= 3.2e-5 per collision; bound 1e-4.
#   conservative (the shipped default): the pe-vjp chain adds zero-mean
#     f32 roundoff noise (+1.1e-4 / -1.2e-4 / +4e-5 across the dt sweep
#     — sign-flipping and dt-INDEPENDENT, i.e. a noise floor, not a
#     secular loss; the 1M-step metric run conserves to +0.0855%).
#     Bound 3e-4 (headon) / 1.5e-3 (oblique, measured +6.6e-4).
@pytest.mark.parametrize("cons,etol", [(False, 1e-4), (True, 3e-4)])
def test_elastic_headon_energy_and_swap(cons, etol):
    sim, state, neigh = scenarios.two_body_collision(
        gamma_n=0.0, dt=2e-4, conservative=cons)
    e0 = float(sim.thermo(state, neigh)["etot"])
    p0 = total_momentum(state, sim)
    state, neigh = sim.run(state, neigh, 3000)
    t1 = sim.thermo(state, neigh)
    # Equal-mass elastic head-on: velocities swap.
    v = np.asarray(state.v)
    assert v[0, 0] == pytest.approx(-1.0, abs=2e-3)
    assert v[1, 0] == pytest.approx(1.0, abs=2e-3)
    assert abs(float(t1["etot"]) - e0) / e0 < etol
    np.testing.assert_allclose(total_momentum(state, sim), p0, atol=1e-5)


def test_damped_restitution_monotonic():
    es = []
    for g in (0.0, 100.0, 300.0):
        sim, state, neigh = scenarios.two_body_collision(gamma_n=g, dt=2e-4)
        state, neigh = sim.run(state, neigh, 3000)
        v = np.asarray(state.v)
        es.append(-v[0, 0])  # outgoing speed = restitution (v0 = 1)
    assert es[0] == pytest.approx(1.0, abs=2e-3)
    assert 0.0 < es[2] < es[1] < es[0]


@pytest.mark.parametrize("cons,etol", [(False, 5e-4), (True, 1.5e-3)])
def test_oblique_collision_conserves_angular_momentum(cons, etol):
    sim, state, neigh = scenarios.two_body_collision(
        gamma_n=0.0, dt=2e-4, conservative=cons)
    # Offset impact parameter in y: glancing collision.
    x = np.array(state.x)
    x[:, 1] = [0.15, -0.15]
    state = state.replace(x=jnp.asarray(x, jnp.float32))
    state, neigh = sim.init_neighbors(state)
    L0 = total_angular_momentum(state, sim)
    e0 = float(sim.thermo(state, neigh)["etot"])
    state, neigh = sim.run(state, neigh, 3000)
    L1 = total_angular_momentum(state, sim)
    e1 = float(sim.thermo(state, neigh)["etot"])
    np.testing.assert_allclose(L1, L0, atol=5e-5)
    assert abs(e1 - e0) / e0 < etol
    # Glancing contact deflects out of the line of centers.
    assert abs(float(state.v[0, 1])) > 1e-3


def test_quaternions_stay_normalized():
    sim, state, neigh = scenarios.two_body_collision(gamma_n=0.0)
    state = state.replace(
        angmom=jnp.asarray([[0.0, 0.0, 0.05], [0.01, 0.02, 0.0]], jnp.float32)
    )
    state, neigh = sim.run(state, neigh, 500)
    norms = np.asarray(jnp.linalg.norm(state.q, axis=-1))
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)
