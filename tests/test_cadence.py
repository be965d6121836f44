"""Static-cadence rebuild mode == displacement-triggered mode
(the fast path: no data-dependent branch in the scan)."""

import jax.numpy as jnp
import numpy as np
import pytest

from spherharm_tpu.models import scenarios


pytestmark = pytest.mark.slow  # minutes-long physics horizons


def test_cadence_matches_triggered():
    kw = dict(n=64, lmax=4, dt=1e-4, k_max=16, drum_omega=0.3,
              n_shape_types=2, contact_quad=(8, 16), pair_capacity=1024,
              pair_chunk=512, drum_radius_factor=8.0, conservative=False)
    sim_a, s_a, n_a = scenarios.rotating_drum(**kw)
    sim_b, s_b, n_b = scenarios.rotating_drum(**kw, rebuild_every=10)
    s_a, n_a = sim_a.run(s_a, n_a, 400)
    s_b, n_b = sim_b.run(s_b, n_b, 400)
    # The Verlet-list guarantee makes forces independent of rebuild
    # timing, so trajectories agree exactly as long as no skin violation
    # occurred.
    assert int(n_b.skin_violations) == 0
    np.testing.assert_allclose(np.asarray(s_a.x), np.asarray(s_b.x),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(s_a.v), np.asarray(s_b.v),
                               atol=1e-4)


def test_cadence_detects_skin_violation():
    # Absurdly long cadence on a fast-moving system must raise the
    # violation counter (detection without branching).
    kw = dict(n=64, lmax=2, dt=1e-3, k_max=16, drum_omega=2.0,
              n_shape_types=1, contact_quad=(6, 12), pair_capacity=1024,
              pair_chunk=512, drum_radius_factor=8.0, conservative=False)
    sim, state, neigh = scenarios.rotating_drum(**kw, rebuild_every=400)
    # Give everything a large velocity so skin/2 is crossed quickly.
    rng = np.random.default_rng(0)
    state = state.replace(
        v=jnp.asarray(rng.normal(size=(state.cap, 3)) * 2.0, jnp.float32)
    )
    state, neigh = sim.run(state, neigh, 800)
    assert int(neigh.skin_violations) > 0
