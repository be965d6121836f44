"""Rebuild-time narrow-phase prefilter == per-step full-list physics.

The prefilter (ops.contact.prefilter_pair_list) compacts the candidate
pair list to near-contact pairs once per rebuild; correctness rests on
the probe bounding every contact's depth and on the rotation-aware skin
trigger (ops.neighbor.max_approach). These pin: trajectory equivalence
vs the unfiltered pair list, the probe's upper bound, the rotation term
of the trigger, and loud overflow when the kept-list capacity is too
small (SURVEY.md 2 B.3/B.4 neighbor + pair orchestration).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spherharm_tpu.core.simulation import Simulation
from spherharm_tpu.core.state import SimParams
from spherharm_tpu.models import scenarios, shapes_library
from spherharm_tpu.ops import contact, neighbor
from spherharm_tpu.ops.contact import minimum_image
from spherharm_tpu.ops.neighbor import CellGrid


def _setup(n=48, lmax=4, seed=3, box=10.0, skin=0.3):
    shapes = shapes_library.build_shapes(
        [shapes_library.blob_coeffs(lmax, seed=t, mean_radius=0.5,
                                    roughness=0.12) for t in range(2)],
        lmax, contact_quad=(8, 16),
    )
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.6, box - 0.6, (n, 3))
    v = rng.normal(size=(n, 3)) * 0.5
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    params = SimParams.create(dt=1e-3, kn=1e4, kt=5e3, gamma_n=5.0,
                              mu=0.3, cutoff=1.3, skin=skin)
    state = scenarios.make_state(
        x, [0, 0, 0], [box] * 3, v=v, q=q,
        shtype=rng.integers(0, 2, n),
    )
    return shapes, params, state


def _mk(shapes, params, box, stage2, pair_cap=2048, **kw):
    grid = CellGrid([0, 0, 0], [box] * 3, 1.6, (True,) * 3)
    # Prefilter equivalence, not drift, is the subject (conservative
    # coverage: test_conservative.py) — geometric keeps CPU cost sane.
    kw.setdefault("conservative", False)
    return Simulation(
        shapes, params, periodic=(True,) * 3, neighbor_mode="cell",
        grid=grid, k_max=24, cell_cap=12, pair_capacity=pair_cap,
        stage2_capacity=stage2, **kw,
    )


def test_prefilter_matches_full_list():
    """Prefiltered (stage-2-compacted) pair list reproduces the full
    candidate-list trajectory: the dropped pairs can exert no force
    before the next rebuild."""
    # Dense enough that many bounding-sphere candidates have real
    # surface gaps beyond the margin (the pairs the probe cuts), with a
    # small skin so the window allowance doesn't re-admit everything.
    box = 7.0
    shapes, params, state0 = _setup(n=72, box=box, skin=0.12)
    sim_a = _mk(shapes, params, box, stage2=0)       # full list
    sim_b = _mk(shapes, params, box, stage2=1024)    # prefiltered
    assert not sim_a.prefilter and sim_b.prefilter

    sa, na = sim_a.init_neighbors(state0)
    sb, nb = sim_b.init_neighbors(state0)
    # Same build positions at init: the prefiltered list must be a
    # strict subset of the candidates (it actually filtered).
    kept = int(jnp.sum(nb.pair_valid))
    cand = int(jnp.sum(na.pair_valid))
    assert 0 < kept < cand, (kept, cand)
    sa, na = sim_a.run(sa, na, 150)
    sb, nb = sim_b.run(sb, nb, 150)
    assert int(na.overflow) == 0 and int(nb.overflow) == 0
    np.testing.assert_allclose(np.asarray(sb.x), np.asarray(sa.x),
                               rtol=0, atol=5e-5)
    np.testing.assert_allclose(np.asarray(sb.v), np.asarray(sa.v),
                               rtol=0, atol=5e-4)
    ta = sim_a.thermo(sa, na)
    tb = sim_b.thermo(sb, nb)
    assert float(tb["etot"]) == pytest.approx(float(ta["etot"]), rel=1e-5)


def test_prefilter_cadence_mode():
    """Same equivalence under the static rebuild cadence (the bench
    configuration), including spring history through rebuilds."""
    box = 10.0
    shapes, params, state0 = _setup(seed=5)
    sim_a = _mk(shapes, params, box, stage2=0, rebuild_every=10)
    sim_b = _mk(shapes, params, box, stage2=1024, rebuild_every=10)
    sa, na = sim_a.init_neighbors(state0)
    sb, nb = sim_b.init_neighbors(state0)
    # 60 steps: long enough for 6 scheduled rebuilds with migrations,
    # short enough that ulp-level summation-order noise (the compacted
    # list sums the same contacts in a different order) stays below
    # tolerance under contact chaos.
    sa, na = sim_a.run(sa, na, 60)
    sb, nb = sim_b.run(sb, nb, 60)
    assert int(nb.overflow) == 0
    assert int(nb.skin_violations) == int(na.skin_violations)
    np.testing.assert_allclose(np.asarray(sb.x), np.asarray(sa.x),
                               rtol=0, atol=1e-4)
    ta = sim_a.thermo(sa, na)
    tb = sim_b.thermo(sb, nb)
    assert float(tb["etot"]) == pytest.approx(float(ta["etot"]), rel=1e-5)


def test_prefilter_overflow_flags():
    """Too-small kept-list capacity must flag loudly, not drop pairs."""
    box = 6.0
    shapes, params, state0 = _setup(n=64, box=box, seed=7)
    sim = _mk(shapes, params, box, stage2=8, pair_cap=4096)
    s, ng = sim.init_neighbors(state0)
    assert int(ng.overflow) > 8


def test_rotation_aware_trigger():
    """max_approach grows with pure rotation (no displacement) scaled
    by gmax; spheres (gmax=0) are immune."""
    lmax = 4
    shapes = shapes_library.build_shapes(
        [shapes_library.ellipsoid_coeffs(0.7, 0.45, 0.45, lmax),
         shapes_library.sphere_coeffs(0.5, lmax)],
        lmax,
    )
    n = 2
    x = np.array([[1.0, 1.0, 1.0], [3.0, 1.0, 1.0]])
    q0 = np.array([[1.0, 0, 0, 0], [1.0, 0, 0, 0]])
    alpha = 0.3
    qrot = np.array([
        [np.cos(alpha / 2), 0.0, 0.0, np.sin(alpha / 2)],
        [1.0, 0, 0, 0],
    ])
    active = np.array([True, True])
    for types, expect_growth in (([0, 0], True), ([1, 1], False)):
        gmax_s = np.asarray(shapes.gmax)[np.asarray(types)]
        appr = neighbor.max_approach(
            jnp.asarray(x), jnp.asarray(x), jnp.asarray(qrot),
            jnp.asarray(q0), jnp.asarray(gmax_s), jnp.asarray(active),
            jnp.zeros(3), jnp.full(3, 10.0), (False,) * 3,
        )
        if expect_growth:
            ref = float(shapes.gmax[0]) * alpha
            assert float(appr) == pytest.approx(ref, rel=1e-4)
        else:
            assert float(appr) < 1e-6

    # A spinning ellipsoid whose long axis rotates toward a neighbor
    # must trigger a rebuild before the bump arrives: the approach
    # bound at angle alpha exceeds the actual radial surface change.
    th = np.linspace(0, np.pi, 200)
    r_of = lambda a: 1.0 / np.sqrt(
        (np.cos(a) / 0.7) ** 2 + (np.sin(a) / 0.45) ** 2
    )
    dr = abs(r_of(0.0) - r_of(alpha))
    assert float(shapes.gmax[0]) * alpha >= dr


def test_probe_bounds_full_depth():
    """The rebuild-time jnp probe (coarse 32-node grid) plus its slack
    bounds the fine-grid node depth of every pair in contact, so the
    prefilter never drops a touching pair at zero motion budget. Packed
    3x3x3 lattice: overlaps up to a third of the mean radius."""
    lmax, n = 6, 27
    rng = np.random.default_rng(3)
    shapes = shapes_library.build_shapes(
        [shapes_library.blob_coeffs(lmax, seed=3 + t, mean_radius=0.5,
                                    roughness=0.12) for t in range(3)],
        lmax, contact_quad=(8, 16))
    g = 1.0 + 0.95 * np.arange(3)
    x = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    state = scenarios.make_state(
        x + rng.uniform(-0.03, 0.03, (n, 3)), [0, 0, 0], [4, 4, 4], q=q,
        scale=rng.uniform(0.85, 1.15, n), shtype=rng.integers(0, 3, n))
    pi, pj = np.triu_indices(n, 1)
    pi, pj = jnp.asarray(pi, jnp.int32), jnp.asarray(pj, jnp.int32)
    mask = jnp.ones(pi.shape, bool)
    rows = contact.particle_rows(state, shapes)
    d = minimum_image(state.x[pj] - state.x[pi], state.box_lo,
                      state.box_hi, (False, False, False))
    rc = jnp.minimum(rows[pi, contact._RRC], rows[pj, contact._RRC])
    bound = np.asarray(contact.probe_pairs(state, shapes, pi, pj, mask, d,
                                           rows)
                       + contact.PROBE_SLACK * rc)
    depth = np.asarray(contact.max_node_depth(
        rows[pi], rows[pj], state.shtype[pi], state.shtype[pj], d, shapes))
    inc = depth > 0
    assert inc.sum() > 30 and depth.max() > 0.1
    assert np.all(bound[inc] >= depth[inc])
    # Masked pairs are never kept.
    masked = contact.probe_pairs(state, shapes, pi, pj,
                                 jnp.zeros_like(mask), d, rows)
    assert float(jnp.max(masked)) <= -1e8


@pytest.mark.slow
def test_two_stage_matches_single_stage():
    """Prefiltered pair list (r-only coarse probe at rebuild -> full
    narrow phase on survivors) must reproduce the unfiltered forces
    exactly: the probe may only cull pairs the full law finds
    force-free."""
    rng = np.random.default_rng(3)
    lmax = 4
    coeffs = np.stack([
        shapes_library.blob_coeffs(lmax, seed=11 + t, mean_radius=0.5,
                                   roughness=0.12)
        for t in range(3)
    ])
    shapes = shapes_library.build_shapes(coeffs, lmax, contact_quad=(8, 16))
    box = 6.0
    n = 80
    # Dense-ish random gas: plenty of bounding-sphere candidates that are
    # NOT touching (the population the probe exists to cull).
    x = rng.uniform(0.8, box - 0.8, (n, 3))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    params = SimParams.create(dt=1e-4, kn=1e5, gamma_n=20.0, mu=0.4,
                              cutoff=1.4, skin=0.3)
    state = scenarios.make_state(
        x, [0, 0, 0], [box] * 3, q=q,
        v=rng.normal(size=(n, 3)) * 0.3,
        scale=rng.uniform(0.85, 1.15, n),
        shtype=rng.integers(0, 3, n),
    )
    grid = CellGrid([0, 0, 0], [box] * 3, 1.7)
    kw = dict(neighbor_mode="cell", grid=grid, k_max=24, cell_cap=12,
              pair_capacity=1024, conservative=False)
    sim_a = Simulation(shapes, params, stage2_capacity=256, **kw)
    sim_b = Simulation(shapes, params, stage2_capacity=0, **kw)
    sa, na = sim_a.init_neighbors(state)
    sb, nb = sim_b.init_neighbors(state)
    sa, na, _ = sim_a.compute_forces(sa, na)
    sb, nb, _ = sim_b.compute_forces(sb, nb)
    assert int(na.overflow) < 256  # stage-2 capacity honored
    assert float(jnp.abs(sa.f).max()) > 0, "should have real contacts"
    np.testing.assert_allclose(np.asarray(sa.f), np.asarray(sb.f),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(sa.tau), np.asarray(sb.tau),
                               rtol=1e-6, atol=1e-6)
    # Pair lists differ in size/order (the prefiltered list is the
    # stage-2 compaction); springs must agree in the dense tag-keyed
    # layout both fold back into.
    np.testing.assert_allclose(
        np.asarray(contact.pair_hist_to_dense(na)),
        np.asarray(contact.pair_hist_to_dense(nb)),
        rtol=1e-6, atol=1e-9,
    )
