"""Per-type-pair material coefficients (LAMMPS pair_coeff i j ... +
geometric mixing; SURVEY.md 2 B.4 Pair base "mixing").

Pins: the mixing rule, trajectory equivalence between a [T, T] table
entry and the same value as a global scalar, jnp/Pallas parity with a
nontrivial table, and the deck `pair_coeff i j` surface.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from spherharm_tpu.core.simulation import Simulation
from spherharm_tpu.core.state import SimParams, pair_material
from spherharm_tpu.io.deck import DeckRunner
from spherharm_tpu.models import scenarios, shapes_library
from spherharm_tpu.ops import contact
from spherharm_tpu.ops.contact import minimum_image


def test_geometric_mixing_defaults():
    p = SimParams.create(dt=1e-3, kn=1e4, kt=4e3, gamma_n=8.0, mu=0.5,
                         k_roll=0.0)
    p2 = p.with_pair_coeffs(
        3,
        {(0, 0): (9e4, 3e4, 2.0, 1.0, 0.3),
         (1, 1): (1e4, 1e4, 8.0, 4.0, 0.6, 100.0, 1.0, 0.1)},
    )
    t = np.asarray(p2.pair_tab)
    assert t.shape == (3, 3, 8)
    # Explicit diagonals kept; unset diagonal = global scalars.
    assert t[0, 0, 0] == pytest.approx(9e4)
    assert t[2, 2, 0] == pytest.approx(1e4)
    assert t[2, 2, 1] == pytest.approx(4e3)
    # Unset off-diagonals: componentwise geometric mean of diagonals.
    assert t[0, 1, 0] == pytest.approx(np.sqrt(9e4 * 1e4))
    assert t[0, 1, 4] == pytest.approx(np.sqrt(0.3 * 0.6))
    # k_roll mixes to 0 when one side disables rolling.
    assert t[0, 1, 5] == 0.0
    # Symmetry and gather.
    np.testing.assert_allclose(t[1, 0], t[0, 1])
    m = pair_material(p2, jnp.asarray([0, 1]), jnp.asarray([1, 1]))
    np.testing.assert_allclose(np.asarray(m[0]), t[0, 1])
    np.testing.assert_allclose(np.asarray(m[1]), t[1, 1])


def _two_sphere_sim(params, dt=2e-4):
    lmax = 0
    shapes = shapes_library.build_shapes(
        [shapes_library.sphere_coeffs(0.5, lmax),
         shapes_library.sphere_coeffs(0.5, lmax)],
        lmax, contact_quad=(12, 24),
    )
    box = 2.0
    state = scenarios.make_state(
        [[-0.6, 0.0, 0.0], [0.6, 0.0, 0.0]],
        [-box, -box, -box], [box, box, box],
        v=[[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]],
        shtype=[0, 1],
    )
    sim = Simulation(shapes, params, neighbor_mode="allpairs", k_max=4, conservative=False)
    st, ng = sim.init_neighbors(state)
    return sim, st, ng


def test_two_material_headon_equivalence():
    """A (0,1) table entry must act exactly like the same kn as a global
    scalar: two materials with pair_coeff 0 1 kn=K2 reproduce the
    single-material K2 trajectory."""
    k1, k2 = 1e5, 3e4
    base = SimParams.create(dt=2e-4, kn=k1, gamma_n=0.0, mu=0.0,
                            skin=0.05, cutoff=1.05)
    tab = base.with_pair_coeffs(2, {(0, 1): (k2, 2 / 7 * k2, 0.0, 0.0, 0.0)})
    ref = SimParams.create(dt=2e-4, kn=k2, gamma_n=0.0, mu=0.0,
                           skin=0.05, cutoff=1.05)
    sim_a, sa, na = _two_sphere_sim(tab)
    sim_b, sb, nb = _two_sphere_sim(ref)
    sa, na = sim_a.run(sa, na, 1500)
    sb, nb = sim_b.run(sb, nb, 1500)
    np.testing.assert_allclose(np.asarray(sa.x), np.asarray(sb.x),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(sa.v), np.asarray(sb.v),
                               atol=1e-6)
    # And the table run actually differs from the global-k1 physics
    # (velocities swap back either way — a softer spring spends longer
    # in contact, shifting the exit positions).
    sim_c, sc, nc = _two_sphere_sim(base)
    sc, nc = sim_c.run(sc, nc, 1500)
    assert not np.allclose(np.asarray(sa.x), np.asarray(sc.x), atol=1e-3)



DECK = """
units lj
boundary f f f
region box block -2 2 -2 2 -2 2
create_box 2 box
shape 1 sphere 0.5
shape 2 sphere 0.5
pair_style spherharm 100000 28571 0 0 0
pair_coeff 1 2 30000 8571 0 0 0
timestep 2e-4
create_atoms 1 single -0.45 0 0
create_atoms 2 single 0.45 0 0
fix 1 all nve/sh
run 20
"""


def test_deck_pair_coeff():
    """Deck pair_coeff 1 2 overrides the pair_style scalars for the
    cross-type pair (the two-material restitution deck translates 1:1),
    and the overlapping pair pushes apart under the table's kn."""
    runner = DeckRunner().run_text(DECK)
    t = np.asarray(runner.sim.params.pair_tab)
    assert t.shape == (2, 2, 8)
    assert t[0, 1, 0] == pytest.approx(30000.0)
    assert t[1, 0, 0] == pytest.approx(30000.0)
    assert t[0, 0, 0] == pytest.approx(100000.0)
    v = np.asarray(runner.state.v)[np.asarray(runner.state.active)]
    assert v[0, 0] < 0 and v[1, 0] > 0  # overlap pushed them apart
