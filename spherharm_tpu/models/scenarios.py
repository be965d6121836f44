"""Builders for the five acceptance configurations (BASELINE.json:7-11).

Each returns (Simulation, State, NeighborState) ready to ``run``. These are
the equivalents of the reference's example input decks
(SURVEY.md section 4.3).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from spherharm_tpu.core.simulation import Simulation
from spherharm_tpu.core.state import SimParams, State, zeros_state
from spherharm_tpu.models import shapes_library
from spherharm_tpu.ops.neighbor import CellGrid
from spherharm_tpu.ops.walls import CylinderWall, PlaneWall


def make_state(
    x,
    box_lo,
    box_hi,
    *,
    v=None,
    q=None,
    angmom=None,
    scale=None,
    shtype=None,
    cap=None,
    tilt=None,
    dtype=jnp.float32,
) -> State:
    """Pack numpy arrays into a fixed-capacity State (extra slots inactive)."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    cap = cap or n
    st = zeros_state(cap, box_lo, box_hi, dtype)
    if tilt is not None:
        st = st.replace(tilt=jnp.asarray(tilt, st.tilt.dtype))
    put = lambda field, val: field.at[:n].set(jnp.asarray(val, field.dtype))
    st = st.replace(
        x=put(st.x, x),
        tag=st.tag.at[:n].set(jnp.arange(1, n + 1, dtype=jnp.int32)),
        active=st.active.at[:n].set(True),
    )
    if v is not None:
        st = st.replace(v=put(st.v, v))
    if q is not None:
        st = st.replace(q=put(st.q, q))
    if angmom is not None:
        st = st.replace(angmom=put(st.angmom, angmom))
    if scale is not None:
        st = st.replace(scale=put(st.scale, scale))
    if shtype is not None:
        st = st.replace(shtype=st.shtype.at[:n].set(jnp.asarray(shtype, jnp.int32)))
    return st


def two_body_collision(
    radius: float = 0.5,
    v0: float = 1.0,
    kn: float = 1.0e5,
    gamma_n: float = 0.0,
    dt: float = 2.0e-4,
    gap: float = 0.2,
    contact_quad=(12, 24),
    conservative: bool = True,
    dtype=jnp.float32,
):
    """Config 1: two Lmax=0 sphere-degenerate SH particles, head-on NVE
    collision with Hertzian normal contact (BASELINE.json:7)."""
    lmax = 0
    shapes = shapes_library.build_shapes(
        [shapes_library.sphere_coeffs(radius, lmax)],
        lmax,
        density=1.0,
        contact_quad=contact_quad,
        dtype=dtype,
    )
    params = SimParams.create(
        dt=dt, kn=kn, gamma_n=gamma_n, mu=0.0,
        skin=0.1 * radius, cutoff=2.0 * radius * 1.05, dtype=dtype,
    )
    half = radius + gap / 2
    box = 4 * radius
    state = make_state(
        [[-half, 0.0, 0.0], [half, 0.0, 0.0]],
        [-box, -box, -box], [box, box, box],
        v=[[v0, 0.0, 0.0], [-v0, 0.0, 0.0]],
        dtype=dtype,
    )
    sim = Simulation(
        shapes, params, neighbor_mode="allpairs", k_max=1,
        conservative=conservative,
    )
    state, neigh = sim.init_neighbors(state)
    return sim, state, neigh


def settling_box(
    n: int = 500,
    lmax: int = 2,
    aspect=(1.0, 0.8, 0.65),
    mean_radius: float = 0.5,
    kn: float = 1.0e5,
    gamma_n: float = 50.0,
    mu: float = 0.3,
    dt: float = 1.0e-4,
    box_side: float | None = None,
    seed: int = 0,
    k_max: int = 32,
    conservative: bool = False,
    dtype=jnp.float32,
):
    """Config 2: ~500 Lmax=2 ellipsoid-like particles settling under
    gravity into a box, Hertz + Coulomb friction (BASELINE.json:8).

    Damped/driven config: secular NVE drift is irrelevant here, so the
    geometric elastic law (conservative=False) is the documented
    recommendation (docs/PHYSICS.md) and the default for this helper —
    the framework-level Simulation default stays conservative."""
    a = mean_radius * np.asarray(aspect) / np.cbrt(np.prod(aspect))
    shapes = shapes_library.build_shapes(
        [shapes_library.ellipsoid_coeffs(a[0], a[1], a[2], lmax)],
        lmax, density=1.0, contact_quad=(8, 16), dtype=dtype,
    )
    rmax = float(shapes.rmax[0])
    if box_side is None:
        # Loose lattice that settles to roughly a half-full box.
        box_side = 2.2 * rmax * int(np.ceil(n ** (1 / 3)))
    rng = np.random.default_rng(seed)
    side_cells = int(np.ceil(n ** (1 / 3)))
    pitch = 2.05 * rmax
    coords = []
    for i in range(n):
        cx, cy, cz = (
            i % side_cells,
            (i // side_cells) % side_cells,
            i // side_cells**2,
        )
        coords.append([
            (cx + 0.5) * pitch - box_side / 2,
            (cy + 0.5) * pitch - box_side / 2,
            (cz + 0.5) * pitch + rmax,
        ])
    x = np.asarray(coords) + rng.uniform(-0.05, 0.05, (n, 3)) * rmax
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    height = box_side + pitch * (n // side_cells**2 + 2)
    box_lo = (-box_side / 2, -box_side / 2, 0.0)
    box_hi = (box_side / 2, box_side / 2, height)

    params = SimParams.create(
        dt=dt, kn=kn, gamma_n=gamma_n, mu=mu,
        gravity=(0.0, 0.0, -10.0),
        skin=0.4 * rmax, cutoff=2.0 * rmax, dtype=dtype,
    )
    cutoff_total = 2.0 * rmax + 0.4 * rmax
    grid = CellGrid(box_lo, box_hi, cutoff_total)
    walls = (
        PlaneWall.create((0, 0, 0), (0, 0, 1)),
        PlaneWall.create((-box_side / 2, 0, 0), (1, 0, 0)),
        PlaneWall.create((box_side / 2, 0, 0), (-1, 0, 0)),
        PlaneWall.create((0, -box_side / 2, 0), (0, 1, 0)),
        PlaneWall.create((0, box_side / 2, 0), (0, -1, 0)),
    )
    state = make_state(x, box_lo, box_hi, q=q, dtype=dtype)
    sim = Simulation(
        shapes, params, neighbor_mode="cell", grid=grid,
        k_max=k_max, cell_cap=12, walls=walls,
        conservative=conservative,
    )
    state, neigh = sim.init_neighbors(state)
    return sim, state, neigh


def rotating_drum(
    n: int = 100_000,
    lmax: int = 8,
    mean_radius: float = 0.5,
    poly_spread: float = 0.25,
    n_shape_types: int = 4,
    drum_radius_factor: float | None = None,
    drum_omega: float = 0.5,
    kn: float = 1.0e5,
    gamma_n: float = 50.0,
    mu: float = 0.5,
    k_roll: float = 2.0e4,
    gamma_roll: float = 20.0,
    mu_roll: float = 0.2,
    dt: float = 1.0e-4,
    seed: int = 0,
    k_max: int = 24,
    pair_chunk: int = 0,
    pair_capacity: int | None = None,
    contact_quad=(8, 16),  # 128 cap nodes
    rebuild_every: int = 0,
    exact_eval: bool = True,
    stage2_capacity: int = 0,
    conservative: bool = True,
    rebuild_chunk: int | None = None,
    dtype=jnp.float32,
):
    """Config 4: N polydisperse Lmax=8 particles in a rotating drum —
    friction + rolling (spring-dashpot-slider ON by default, matching
    BASELINE.json:10 'friction + rolling'), full neighbor-rebuild
    cadence; the throughput benchmark scenario."""
    rng = np.random.default_rng(seed)
    coeffs = np.stack([
        shapes_library.blob_coeffs(
            lmax, seed=seed + t, mean_radius=mean_radius, roughness=0.12
        )
        for t in range(n_shape_types)
    ])
    shapes = shapes_library.build_shapes(
        coeffs, lmax, density=1.0, contact_quad=contact_quad, dtype=dtype
    )
    rmax = float(jnp.max(shapes.rmax)) * (1 + poly_spread)

    # Drum: axis along y, length = radius, sized so the initial simple-cubic
    # packing (pitch 2.05*rmax) fills ~40% of the cross-section.
    pitch = 2.05 * rmax
    if drum_radius_factor is None:
        R_drum = pitch * (2.5 * n / np.pi) ** (1 / 3)
    else:
        R_drum = drum_radius_factor * rmax
    L_drum = R_drum  # drum length along axis

    # Initial loose packing from the bottom of the drum up.
    pts = []
    nx = int(2 * R_drum / pitch) - 1
    ny = int(L_drum / pitch)
    z = -R_drum + pitch
    while len(pts) < n and z < R_drum:
        for ix in range(nx):
            for iy in range(ny):
                px = -R_drum + (ix + 0.5) * pitch
                py = -L_drum / 2 + (iy + 0.5) * pitch
                if px**2 + z**2 < (R_drum - pitch) ** 2:
                    pts.append([px, py, z])
        z += pitch
    if len(pts) < n:
        raise ValueError(
            f"drum too small: packed {len(pts)} < {n}; raise drum_radius_factor"
        )
    x = np.asarray(pts[:n]) + rng.uniform(-0.02, 0.02, (n, 3)) * rmax
    scale = rng.uniform(1 - poly_spread, 1 + poly_spread, n)
    shtype = rng.integers(0, n_shape_types, n)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)

    box = R_drum * 1.1
    box_lo = (-box, -L_drum / 2 - rmax, -box)
    box_hi = (box, L_drum / 2 + rmax, box)
    params = SimParams.create(
        dt=dt, kn=kn, gamma_n=gamma_n, mu=mu,
        k_roll=k_roll, gamma_roll=gamma_roll, mu_roll=mu_roll,
        gravity=(0.0, 0.0, -10.0),
        skin=0.4 * rmax, cutoff=2.0 * rmax, dtype=dtype,
    )
    grid = CellGrid(box_lo, box_hi, 2.4 * rmax)
    walls = (
        CylinderWall.create((0, 0, 0), (0, 1, 0), R_drum, omega=drum_omega),
        PlaneWall.create((0, -L_drum / 2, 0), (0, 1, 0)),
        PlaneWall.create((0, L_drum / 2, 0), (0, -1, 0)),
    )
    state = make_state(
        x, box_lo, box_hi, q=q, scale=scale, shtype=shtype, dtype=dtype
    )
    if pair_capacity is None:
        pair_capacity = 10 * n
    # Near-wall fraction ~ (shell area * rmax) / drum volume.
    wall_cap = max(1024, min(n, int(8.0 * n * rmax / R_drum)))
    sim = Simulation(
        shapes, params, neighbor_mode="cell", grid=grid,
        k_max=k_max, cell_cap=10, walls=walls, pair_chunk=pair_chunk,
        pair_capacity=pair_capacity,
        rebuild_every=rebuild_every, exact_eval=exact_eval,
        wall_capacity=wall_cap, stage2_capacity=stage2_capacity,
        conservative=conservative, rebuild_chunk=rebuild_chunk,
    )
    state, neigh = sim.init_neighbors(state)
    return sim, state, neigh


def triaxial_cell(
    n: int = 512,
    lmax: int = 4,
    mean_radius: float = 0.5,
    fill_fraction: float = 0.35,
    strain_rate=(-0.05, -0.05, -0.05),
    shear_rate=(0.0, 0.0, 0.0),
    press_target: float = 0.0,
    press_tau: float = 0.0,
    kn: float = 1.0e5,
    gamma_n: float = 50.0,
    mu: float = 0.4,
    dt: float = 1.0e-4,
    seed: int = 0,
    k_max: int = 32,
    n_shape_types: int = 2,
    deform_min: float = 0.6,
    dtype=jnp.float32,
    sharded: bool = False,
    mesh=None,
    cap_local: int = 0,
    halo_cap: int = 0,
    conservative: bool = False,
    pair_chunk: int = 0,
):
    """Config 5: triaxial shear cell with periodic boundaries and
    stress-tensor output (BASELINE.json:11). Diagonal strain-rate control
    compresses the cell; the stress tensor comes from the kinetic +
    virial sums in thermo. ``sharded=True`` builds the multi-device
    variant (halo exchange via lax collectives) on the given mesh: slabs
    (ShardedSimulation) on a 1D ("x",) mesh, a brick (BrickSimulation)
    on a 2D/3D ("x", "y"[, "z"]) mesh.
    """
    rng = np.random.default_rng(seed)
    coeffs = np.stack([
        shapes_library.blob_coeffs(
            lmax, seed=seed + 100 + t, mean_radius=mean_radius, roughness=0.10
        )
        for t in range(n_shape_types)
    ])
    shapes = shapes_library.build_shapes(coeffs, lmax, density=1.0,
                                         dtype=dtype)
    rmax = float(jnp.max(shapes.rmax))

    # Cubic periodic cell sized for the target initial solid fraction.
    vol_mean = float(jnp.mean(shapes.vol))
    box = (n * vol_mean / fill_fraction) ** (1 / 3)
    side = int(np.ceil(n ** (1 / 3)))
    pitch = box / side
    if pitch < 2.0 * rmax:
        raise ValueError("fill_fraction too high for non-overlapping start")
    pts = []
    for i in range(n):
        cx, cy, cz = i % side, (i // side) % side, i // side**2
        pts.append([(cx + 0.5) * pitch, (cy + 0.5) * pitch, (cz + 0.5) * pitch])
    x = np.asarray(pts) + rng.uniform(-0.05, 0.05, (n, 3)) * rmax
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    v = rng.normal(size=(n, 3)) * 0.05
    shtype = rng.integers(0, n_shape_types, n)

    params = SimParams.create(
        dt=dt, kn=kn, gamma_n=gamma_n, mu=mu,
        skin=0.4 * rmax, cutoff=2.0 * rmax,
        deform_rate=strain_rate, shear_rate=shear_rate,
        press_target=(press_target,) * 3, press_tau=press_tau,
        dtype=dtype,
    )
    state = make_state(x, [0, 0, 0], [box, box, box], v=v, q=q,
                       shtype=shtype, dtype=dtype)
    periodic = (True, True, True)
    triclinic = any(abs(s) > 0 for s in shear_rate)
    if sharded:
        from spherharm_tpu.parallel.brick import BrickSimulation
        from spherharm_tpu.parallel.halo import ShardedSimulation

        n_dev = mesh.devices.size
        cls = ShardedSimulation if mesh.devices.ndim == 1 else BrickSimulation
        sim = cls(
            shapes, params, mesh=mesh, box_lo=(0, 0, 0),
            box_hi=(box, box, box),
            cap_local=cap_local or max(4 * n // n_dev, 64),
            halo_cap=halo_cap or max(2 * n // n_dev, 64),
            periodic=periodic, k_max=k_max, cell_cap=12,
            pair_capacity=max(12 * n // n_dev, 256),
            deform_min=deform_min,
            triclinic=triclinic,
            conservative=conservative,
            # covers |xy| up to 12% of the box; longer shear runs should
            # pass their own pad via halo_cap/slab sizing
            tilt_pad=0.12 * box if triclinic else 0.0,
        )
        st, ng, gh = sim.init(state)
        return sim, st, ng, gh
    grid = CellGrid(
        [0, 0, 0], [box * deform_min] * 3,
        2.4 * rmax * (1.4 if triclinic else 1.0), periodic
    )
    sim = Simulation(
        shapes, params, periodic=periodic, neighbor_mode="cell", grid=grid,
        k_max=k_max, cell_cap=16, pair_capacity=max(12 * n, 512),
        pair_chunk=pair_chunk,
        press_control=press_tau > 0, triclinic=triclinic,
        conservative=conservative,
    )
    st, ng = sim.init_neighbors(state)
    return sim, st, ng


def deposition(
    n: int = 10_000,
    lmax: int = 8,
    contact_quad=(12, 24),
    **kw,
):
    """Config 3: deposition of scanned-shape Lmax=8 particles with
    high-order quadrature grids — torque/rotation fidelity
    (BASELINE.json:9). Same geometry as the drum, spinning disabled.
    Damped config: geometric elastic law by default (see settling_box)."""
    kw.setdefault("conservative", False)
    return rotating_drum(
        n=n, lmax=lmax, drum_omega=0.0, contact_quad=contact_quad, **kw
    )
