"""Sharded == single-device equivalence on a virtual 8-device CPU mesh
(config 5 groundwork, BASELINE.json:11; SURVEY.md 4.2 "multi-node without
a cluster")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from spherharm_tpu.core.simulation import Simulation
from spherharm_tpu.core.state import SimParams
from spherharm_tpu.models import scenarios, shapes_library
from spherharm_tpu.ops.neighbor import CellGrid
from spherharm_tpu.parallel.halo import ShardedSimulation


pytestmark = pytest.mark.slow  # minutes-long physics horizons


def _setup(n=96, lmax=2, seed=0, dtype=jnp.float32):
    """Periodic box of ellipsoids with random velocities (gas-like)."""
    rng = np.random.default_rng(seed)
    shapes = shapes_library.build_shapes(
        [shapes_library.ellipsoid_coeffs(0.55, 0.45, 0.4, lmax)],
        lmax, contact_quad=(6, 12), dtype=dtype,
    )
    box = 8.0
    # Lattice spacing > diameter: non-overlapping start.
    side = int(np.ceil(n ** (1 / 3)))
    pitch = box / side
    pts = []
    for i in range(n):
        cx, cy, cz = i % side, (i // side) % side, i // side**2
        pts.append([(cx + 0.5) * pitch, (cy + 0.5) * pitch, (cz + 0.5) * pitch])
    x = np.asarray(pts) + rng.uniform(-0.08, 0.08, (n, 3))
    v = rng.normal(size=(n, 3)) * 0.5
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    params = SimParams.create(
        dt=1e-3, kn=1e4, gamma_n=5.0, mu=0.3,
        cutoff=1.2, skin=0.3, dtype=dtype,
    )
    state = scenarios.make_state(
        x, [0, 0, 0], [box, box, box], v=v, q=q, dtype=dtype
    )
    return shapes, params, state, box


def test_sharded_matches_single_device():
    n_dev = 4
    shapes, params, state0, box = _setup()
    periodic = (True, True, True)

    # Single-device reference.
    grid = CellGrid([0, 0, 0], [box, box, box], 1.5, periodic)
    sim1 = Simulation(
        shapes, params, periodic=periodic, neighbor_mode="cell",
        grid=grid, k_max=24, cell_cap=12, pair_capacity=1024,
        conservative=False,
    )
    s1, n1 = sim1.init_neighbors(state0)
    s1, n1 = sim1.run(s1, n1, 120)
    t1 = sim1.thermo(s1, n1)

    # Sharded run.
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("x",))
    sim8 = ShardedSimulation(
        shapes, params, mesh=mesh, box_lo=(0, 0, 0), box_hi=(box, box, box),
        cap_local=96, halo_cap=64, migrate_cap=32,
        periodic=periodic, k_max=24, cell_cap=12, pair_capacity=768,
        conservative=False,
    )
    s8, ng8, gh8 = sim8.init(state0)
    s8, ng8, gh8 = sim8.run(s8, ng8, gh8, 120)
    t8 = sim8.thermo(s8, ng8, gh8)
    assert int(t8["neigh_overflow"]) <= max(24, 64)

    # Compare per-tag positions/velocities.
    def by_tag(state):
        tags = np.asarray(state.tag)
        act = np.asarray(state.active)
        order = {}
        for field in ("x", "v", "q", "angmom"):
            arr = np.asarray(getattr(state, field))
            order[field] = {int(t): arr[i] for i, t in enumerate(tags) if act[i]}
        return order

    a, b = by_tag(s1), by_tag(s8)
    assert set(a["x"].keys()) == set(b["x"].keys())
    for t in a["x"]:
        np.testing.assert_allclose(a["x"][t], b["x"][t], atol=2e-3,
                                   err_msg=f"x mismatch tag {t}")
        np.testing.assert_allclose(a["v"][t], b["v"][t], atol=5e-3,
                                   err_msg=f"v mismatch tag {t}")
    # Thermo parity.
    assert float(t8["ke"]) == pytest.approx(float(t1["ke"]), rel=1e-3)
    assert float(t8["etot"]) == pytest.approx(float(t1["etot"]), rel=1e-3)
    np.testing.assert_allclose(
        np.asarray(t8["stress"]), np.asarray(t1["stress"]),
        rtol=2e-2, atol=1e-3,
    )


def test_migration_preserves_particles():
    """Drive particles across slab boundaries; none lost or duplicated."""
    n_dev = 4
    shapes, params, state0, box = _setup(n=64, seed=2)
    # Strong x-drift so slabs are crossed quickly.
    v = np.array(state0.v)
    v[:, 0] += 2.0
    state0 = state0.replace(v=jnp.asarray(v, jnp.float32))
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("x",))
    sim = ShardedSimulation(
        shapes, params, mesh=mesh, box_lo=(0, 0, 0), box_hi=(box, box, box),
        cap_local=64, halo_cap=48, migrate_cap=32,
        periodic=(True, True, True), k_max=24, cell_cap=12,
        pair_capacity=512,
        conservative=False,
    )
    s, ng, gh = sim.init(state0)
    tags0 = sorted(
        int(t) for t, a in zip(np.asarray(s.tag), np.asarray(s.active)) if a
    )
    for _ in range(6):
        s, ng, gh = sim.run(s, ng, gh, 100)
    tags1 = sorted(
        int(t) for t, a in zip(np.asarray(s.tag), np.asarray(s.active)) if a
    )
    assert tags0 == tags1 == list(range(1, 65))
    assert int(ng.overflow) < 512
    # Particles did spread across shards: each shard owns some.
    # (positions may drift slightly past edges between rebuilds -> clip)
    slab = np.clip(np.asarray(s.x)[:, 0] // (box / n_dev), 0, n_dev - 1)
    act = np.asarray(s.active)
    assert len({int(v) for v in slab[act]}) == n_dev


def test_seam_crossing_pairs_match_single_device():
    """Contacting pairs cross the periodic seam AND interior slab
    boundaries mid-contact; the sharded trajectory must match the
    single-device one (exercises: no seam shift on migration buffers,
    friction springs shipped with migrating particles -- a dropped
    spring shows up as a ~5e-2 vy divergence, 5x the tolerance)."""
    n_dev = 4
    lmax = 2
    dtype = jnp.float32
    shapes = shapes_library.build_shapes(
        [shapes_library.ellipsoid_coeffs(0.55, 0.45, 0.4, lmax)],
        lmax, contact_quad=(6, 12), dtype=dtype,
    )
    box = 8.0
    periodic = (True, True, True)
    # One gently-overlapping pair straddles each slab boundary
    # (x = 0/8, 2, 4, 6) at two heights: overlap 0.08, slow shear
    # (vy = +/-0.05, mu = 1 -> springs far from the Coulomb cap, so a
    # dropped spring cannot self-heal by saturation), fast common drift
    # (vx ~ 8, slightly closing) so the left member crosses at ~step 40
    # while the damped contact is live (contact lasts to ~step 120,
    # measured; friction visibly decays vy from 0.05 to 0.039).
    pts, vel = [], []
    for bi, bx in enumerate((0.0, 2.0, 4.0, 6.0)):
        for hj, z in enumerate((2.0, 6.0)):
            y = 1.5 + 1.5 * bi + 0.35 * hj
            pts.append([(bx - 0.15) % box, y % box, z])
            pts.append([(bx + 0.87) % box, y % box, z])
            vel.append([8.2, 0.05, 0.0])
            vel.append([7.8, -0.05, 0.0])
    x = np.asarray(pts)
    v = np.asarray(vel)
    params = SimParams.create(
        dt=5e-4, kn=2e3, gamma_n=10.0, mu=1.0,
        cutoff=1.2, skin=0.3, dtype=dtype,
    )
    state0 = scenarios.make_state(x, [0, 0, 0], [box, box, box], v=v,
                                  dtype=dtype)

    grid = CellGrid([0, 0, 0], [box, box, box], 1.5, periodic)
    sim1 = Simulation(
        shapes, params, periodic=periodic, neighbor_mode="cell",
        grid=grid, k_max=8, cell_cap=8, pair_capacity=256,
        conservative=False,
    )
    s1, n1 = sim1.init_neighbors(state0)

    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("x",))
    sim8 = ShardedSimulation(
        shapes, params, mesh=mesh, box_lo=(0, 0, 0),
        box_hi=(box, box, box), cap_local=32, halo_cap=16, migrate_cap=8,
        periodic=periodic, k_max=8, cell_cap=8, pair_capacity=128,
        conservative=False,
    )
    s8, ng8, gh8 = sim8.init(state0)

    L = box
    for leg in range(4):
        s1, n1 = sim1.run(s1, n1, 64)
        s8, ng8, gh8 = sim8.run(s8, ng8, gh8, 64)
        tags8 = np.asarray(s8.tag)
        act8 = np.asarray(s8.active)
        x8 = {int(t): np.asarray(s8.x)[i] for i, t in enumerate(tags8)
              if act8[i]}
        v8 = {int(t): np.asarray(s8.v)[i] for i, t in enumerate(tags8)
              if act8[i]}
        assert sorted(x8.keys()) == list(range(1, 17)), f"leg {leg}"
        for i in range(16):
            t = i + 1
            # sharded x is wrapped at rebuilds; compare modulo box
            dx = (x8[t] - np.asarray(s1.x)[i] + L / 2) % L - L / 2
            np.testing.assert_allclose(
                dx, 0.0, atol=1e-2, err_msg=f"x mismatch tag {t} leg {leg}"
            )
            np.testing.assert_allclose(
                v8[t], np.asarray(s1.v)[i], atol=1e-2,
                err_msg=f"v mismatch tag {t} leg {leg}",
            )
        if leg == 0:
            # Mid-contact checkpoint (step 64; crossings done at ~40,
            # contact live to ~120): per-pair springs must MATCH, not
            # merely exist — a spring dropped at migration re-grows to
            # only ~40% of the true value by now (measured), so rtol
            # 0.25 cleanly separates shipped from dropped. Live springs
            # ride in PAIR space between rebuilds; look them up there
            # (the spring of direction b->a is the negation of a->b).
            def live_spring(ng, row_tags, n_blk, pc, rows_blk,
                            tag_a, tag_b):
                pi_a = np.asarray(ng.pair_i)
                pj_a = np.asarray(ng.pair_j)
                ok = np.asarray(ng.pair_valid)
                ph = np.asarray(ng.pair_hist)
                for dblk in range(n_blk):
                    sl = slice(dblk * pc, (dblk + 1) * pc)
                    ti = row_tags[dblk * rows_blk + pi_a[sl]]
                    tj = row_tags[dblk * rows_blk + pj_a[sl]]
                    fwd = ok[sl] & (ti == tag_a) & (tj == tag_b)
                    rev = ok[sl] & (ti == tag_b) & (tj == tag_a)
                    if fwd.any():
                        return ph[sl][fwd][0, :3]
                    if rev.any():
                        return -ph[sl][rev][0, :3]
                raise AssertionError(
                    f"no live pair for tags {tag_a},{tag_b}"
                )

            rt8 = np.asarray(ng8.row_tag)
            rt1 = np.asarray(n1.row_tag)
            for pi in range(8):
                t_left, t_right = 2 * pi + 1, 2 * pi + 2
                h1v = live_spring(n1, rt1, 1, sim1.pair_capacity,
                                  s1.cap, t_left, t_right)
                h8v = live_spring(ng8, rt8, n_dev, sim8.pair_capacity,
                                  sim8.cap_ext, t_left, t_right)
                n1v = np.linalg.norm(h1v)
                assert n1v > 1e-4, f"pair {pi}: single-device spring empty"
                assert np.linalg.norm(h8v - h1v) < 0.25 * n1v, (
                    f"pair {pi}: sharded spring {h8v} vs single {h1v} "
                    "(dropped at migration?)"
                )
    assert int(ng8.overflow) < 128


def test_sharded_restart_roundtrip(tmp_path):
    """gather_restart -> write_restart -> read -> re-init on a DIFFERENT
    mesh width -> run; must match the uninterrupted sharded run per tag
    (VERDICT r1 weak-5). Mid-contact springs must survive the gather/
    redistribute, so the scenario keeps dense persistent contacts."""
    from spherharm_tpu.io import restart as rio
    from spherharm_tpu.ops.walls import PlaneWall

    lmax = 2
    rng = np.random.default_rng(6)
    shapes = shapes_library.build_shapes(
        [shapes_library.ellipsoid_coeffs(0.55, 0.45, 0.4, lmax)],
        lmax, contact_quad=(6, 12),
    )
    box = 8.0
    # Two stacked layers resting on a floor wall: persistent pair AND
    # wall springs exist at the checkpoint (so dropping either diverges).
    pts = []
    for layer, z in enumerate((0.46, 1.32)):
        for i in range(24):
            px = (i % 6) * 1.3 + 0.7 + 0.08 * layer
            py = (i // 6) * 1.3 + 0.7
            pts.append([px, py, z])
    x = np.asarray(pts) + rng.uniform(-0.03, 0.03, (48, 3))
    v = rng.normal(size=(48, 3)) * 0.1
    params = SimParams.create(
        dt=1e-3, kn=1e4, gamma_n=30.0, mu=1.0,
        gravity=(0.0, 0.0, -5.0), cutoff=1.2, skin=0.3,
    )
    state0 = scenarios.make_state(x, [0, 0, 0], [box, box, 4.0], v=v)
    walls = (PlaneWall.create((0, 0, 0), (0, 0, 1)),)
    mesh4 = Mesh(np.array(jax.devices()[:4]), ("x",))
    kw = dict(
        shapes=shapes, params=params, walls=walls,
        box_lo=(0, 0, 0), box_hi=(box, box, 4.0),
        cap_local=48, halo_cap=32, migrate_cap=16,
        periodic=(True, True, False), k_max=16, cell_cap=12,
        pair_capacity=512,
        conservative=False,
    )
    sim_a = ShardedSimulation(mesh=mesh4, **kw)
    sa, na, ga = sim_a.init(state0)
    sa, na, ga = sim_a.run(sa, na, ga, 250)

    # Checkpoint mid-run.
    gstate, payload = sim_a.gather_restart(sa, na)
    p = tmp_path / "shard.npz"
    rio.write_restart(p, gstate, None, params, extra=payload)
    gstate2, _, params2, extra = rio.read_restart(p)

    # Resume on a 2-device mesh (different decomposition).
    mesh2 = Mesh(np.array(jax.devices()[:2]), ("x",))
    kw2 = dict(kw, params=params2, cap_local=64, halo_cap=48)
    sim_b = ShardedSimulation(mesh=mesh2, **kw2)
    sb, nb, gb = sim_b.init(gstate2, restart=extra)

    # Reference: the uninterrupted run.
    sa, na, ga = sim_a.run(sa, na, ga, 200)
    sb, nb, gb = sim_b.run(sb, nb, gb, 200)

    def by_tag(state, field):
        tags = np.asarray(state.tag)
        act = np.asarray(state.active)
        arr = np.asarray(getattr(state, field))
        return {int(t): arr[i] for i, t in enumerate(tags) if act[i]}

    xa, xb = by_tag(sa, "x"), by_tag(sb, "x")
    va, vb = by_tag(sa, "v"), by_tag(sb, "v")
    assert set(xa) == set(xb)
    for t in xa:
        np.testing.assert_allclose(xb[t], xa[t], atol=2e-3,
                                   err_msg=f"x tag {t}")
        np.testing.assert_allclose(vb[t], va[t], atol=5e-3,
                                   err_msg=f"v tag {t}")


def test_weighted_balance_matches_uniform():
    """Load-balanced (weighted) slab bounds: a clustered gas balanced by
    particle-count quantiles must produce the SAME physics as uniform
    slabs, with better per-shard occupancy (LAMMPS `balance` analogue,
    VERDICT r1 missing-7).

    NOTE: runs with the persistent compilation cache DISABLED — the
    XLA executable serializer segfaults on this particular sharded
    program (searchsorted bounds under shard_map; observed on both the
    write and the read path, jaxlib 0.9.0). Physics is unaffected."""
    from spherharm_tpu.parallel.halo import balance_fracs

    # jax_compilation_cache_dir=None does NOT deactivate an already-
    # initialized cache backend; the enable flag is checked per compile.
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        _run_weighted_balance_case(balance_fracs)
    finally:
        jax.config.update("jax_enable_compilation_cache", True)


def _run_weighted_balance_case(balance_fracs):

    n_dev = 4
    lmax = 2
    rng = np.random.default_rng(11)
    shapes = shapes_library.build_shapes(
        [shapes_library.ellipsoid_coeffs(0.55, 0.45, 0.4, lmax)],
        lmax, contact_quad=(6, 12),
    )
    box = 16.0
    # Cluster 3/4 of the particles in the left third of the box.
    n = 72
    x = np.concatenate([
        rng.uniform([0.3, 0.3, 0.3], [5.0, 7.7, 7.7], (54, 3)),
        rng.uniform([5.5, 0.3, 0.3], [15.7, 7.7, 7.7], (18, 3)),
    ])
    v = rng.normal(size=(n, 3)) * 0.4
    params = SimParams.create(dt=1e-3, kn=1e4, gamma_n=5.0, mu=0.3,
                              cutoff=1.2, skin=0.3)
    state0 = scenarios.make_state(x, [0, 0, 0], [box, 8.0, 8.0], v=v)

    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("x",))
    kw = dict(
        shapes=shapes, params=params, mesh=mesh,
        box_lo=(0, 0, 0), box_hi=(box, 8.0, 8.0),
        halo_cap=48, migrate_cap=24,
        periodic=(True, True, True), k_max=16, cell_cap=10,
        pair_capacity=512,
        conservative=False,
    )
    fr = balance_fracs(state0, n_dev,
                       min_frac=1.02 * float(params.cutoff + params.skin)
                       / box)
    assert fr[1] < 0.25  # boundaries moved toward the cluster
    sim_u = ShardedSimulation(cap_local=72, **kw)
    su, nu, gu = sim_u.init(state0)
    # Balanced decomposition needs much less slack per shard (48 holds
    # because the narrowest slab now owns ~n/4 = 18; uniform slabs would
    # put ~43 of the clustered 54 into slab 0 and overflow this cap).
    sim_b = ShardedSimulation(cap_local=48, bounds_frac=fr, **kw)
    sb, nb, gb = sim_b.init(state0)

    su, nu, gu = sim_u.run(su, nu, gu, 150)
    sb, nb, gb = sim_b.run(sb, nb, gb, 150)
    assert int(nb.overflow) < 512

    def by_tag(state, field):
        tags = np.asarray(state.tag)
        act = np.asarray(state.active)
        arr = np.asarray(getattr(state, field))
        return {int(t): arr[i] for i, t in enumerate(tags) if act[i]}

    xu, xb = by_tag(su, "x"), by_tag(sb, "x")
    vu, vb = by_tag(su, "v"), by_tag(sb, "v")
    assert set(xu) == set(xb) == set(range(1, n + 1))
    L = box
    for t in xu:
        dx = (xb[t] - xu[t] + L / 2) % L - L / 2
        np.testing.assert_allclose(dx, 0.0, atol=1e-3,
                                   err_msg=f"x tag {t}")
        np.testing.assert_allclose(vb[t], vu[t], atol=2e-3,
                                   err_msg=f"v tag {t}")


def test_sharded_prefilter_matches_single_device():
    """Sharded run with the REBUILD-CADENCE PREFILTER (stage2_capacity:
    the production bench configuration) matches the
    plain single-device jnp trajectory per tag — pins the sharded
    prefilter wiring (budget leaf sharding, stage2-sized pair leaves,
    approach_ratio trigger under pmax)."""
    n_dev = 4
    shapes, params, state0, box = _setup(n=72, seed=5)
    periodic = (True, True, True)

    grid = CellGrid([0, 0, 0], [box, box, box], 1.5, periodic)
    sim1 = Simulation(
        shapes, params, periodic=periodic, neighbor_mode="cell",
        grid=grid, k_max=24, cell_cap=12, pair_capacity=1024,
        conservative=False,
    )
    s1, n1 = sim1.init_neighbors(state0)
    s1, n1 = sim1.run(s1, n1, 80)
    t1 = sim1.thermo(s1, n1)

    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("x",))
    simp = ShardedSimulation(
        shapes, params, mesh=mesh, box_lo=(0, 0, 0),
        box_hi=(box, box, box),
        cap_local=96, halo_cap=64, migrate_cap=32,
        periodic=periodic, k_max=24, cell_cap=12, pair_capacity=768,
        stage2_capacity=256,
        conservative=False,
    )
    sp, ngp, ghp = simp.init(state0)
    assert ngp.pair_i.shape[0] == n_dev * 256  # stage2-sized pair leaves
    sp, ngp, ghp = simp.run(sp, ngp, ghp, 80)
    tp = simp.thermo(sp, ngp, ghp)
    assert int(tp["neigh_overflow"]) == 0

    tags1 = np.asarray(s1.tag)[np.asarray(s1.active)]
    x1 = {int(t): np.asarray(s1.x)[i]
          for i, t in zip(np.where(np.asarray(s1.active))[0], tags1)}
    tagsp = np.asarray(sp.tag)[np.asarray(sp.active)]
    xp = {int(t): np.asarray(sp.x)[i]
          for i, t in zip(np.where(np.asarray(sp.active))[0], tagsp)}
    assert set(x1.keys()) == set(xp.keys())
    for t in x1:
        np.testing.assert_allclose(xp[t], x1[t], atol=3e-3,
                                   err_msg=f"x mismatch tag {t}")
    assert float(tp["etot"]) == pytest.approx(float(t1["etot"]), rel=2e-3)


def test_inrun_rebalance_no_recompile():
    """Mid-run rebalance(): bounds swap via the traced GhostPack leaf,
    one forced rebuild migrates ownership, trajectory stays identical
    to the single-device reference, and the already-compiled run
    program is reused (no retrace — pinned via jax internals)."""
    n_dev = 4
    shapes, params, state0, box = _setup(n=72, seed=8)
    periodic = (True, True, True)

    grid = CellGrid([0, 0, 0], [box, box, box], 1.5, periodic)
    sim1 = Simulation(
        shapes, params, periodic=periodic, neighbor_mode="cell",
        grid=grid, k_max=24, cell_cap=12, pair_capacity=1024,
        conservative=False,
    )
    s1, n1 = sim1.init_neighbors(state0)
    s1, n1 = sim1.run(s1, n1, 60)
    s1, n1 = sim1.run(s1, n1, 60)

    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("x",))
    sim8 = ShardedSimulation(
        shapes, params, mesh=mesh, box_lo=(0, 0, 0),
        box_hi=(box, box, box),
        cap_local=96, halo_cap=64, migrate_cap=32,
        periodic=periodic, k_max=24, cell_cap=12, pair_capacity=768,
        conservative=False,
    )
    s8, ng8, gh8 = sim8.init(state0)
    s8, ng8, gh8 = sim8.run(s8, ng8, gh8, 60)
    from spherharm_tpu.parallel import halo as halo_mod
    n_traces = halo_mod._run_jit._cache_size()
    fr_before = np.asarray(jax.device_get(gh8.fracs))
    s8, ng8, gh8 = sim8.rebalance(s8, ng8, gh8)
    fr_after = np.asarray(jax.device_get(gh8.fracs))
    assert not np.allclose(fr_before, fr_after)  # bounds actually moved
    s8, ng8, gh8 = sim8.run(s8, ng8, gh8, 60)
    # No retrace of the step program from the bounds swap.
    assert halo_mod._run_jit._cache_size() == n_traces
    t8 = sim8.thermo(s8, ng8, gh8)
    assert int(t8["neigh_overflow"]) <= 64

    tags1 = np.asarray(s1.tag)[np.asarray(s1.active)]
    x1 = {int(t): np.asarray(s1.x)[i]
          for i, t in zip(np.where(np.asarray(s1.active))[0], tags1)}
    tags8 = np.asarray(s8.tag)[np.asarray(s8.active)]
    x8 = {int(t): np.asarray(s8.x)[i]
          for i, t in zip(np.where(np.asarray(s8.active))[0], tags8)}
    assert set(x1.keys()) == set(x8.keys())
    for t in x1:
        np.testing.assert_allclose(x8[t], x1[t], atol=3e-3,
                                   err_msg=f"x mismatch tag {t}")
