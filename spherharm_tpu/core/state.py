"""Core pytree containers: State, Shapes, NeighborState, SimParams.

This is the array-program collapse of the reference's Atom/AtomVec layer
(SURVEY.md section 2 B.2: per-atom arrays x, v, f, omega/angmom, quat,
shtype -> coefficient table) into struct-of-arrays pytrees
(BASELINE.json:5 "pure-functional state API (positions, quaternions, SH
coefficient tables)").

Fixed capacity everywhere: ``State`` holds ``cap`` particle slots with an
``active`` mask (the fixed-shape answer to LAMMPS's dynamic per-atom arrays), and
``NeighborState`` holds a fixed-K neighbor tensor with validity mask.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from spherharm_tpu.utils import struct


@struct.dataclass
class State:
    """Dynamic per-particle state + box. One pytree = one checkpoint."""

    x: jax.Array        # [cap, 3] positions (world)
    v: jax.Array        # [cap, 3] velocities
    q: jax.Array        # [cap, 4] orientation quaternions (scalar first)
    angmom: jax.Array   # [cap, 3] angular momentum (world frame)
    f: jax.Array        # [cap, 3] force accumulator
    tau: jax.Array      # [cap, 3] torque accumulator
    scale: jax.Array    # [cap]    per-particle size factor (polydispersity)
    shtype: jax.Array   # [cap]    int32 shape-type index into Shapes tables
    tag: jax.Array      # [cap]    int32 persistent global particle id (1-based;
                        #          0 = empty slot), LAMMPS "atom tag"
    active: jax.Array   # [cap]    bool slot validity
    image: jax.Array    # [cap, 3] int32 PBC image counters
    box_lo: jax.Array   # [3]
    box_hi: jax.Array   # [3]
    tilt: jax.Array     # [3] triclinic tilt factors (xy, xz, yz); box edge
                        # vectors a=(Lx,0,0), b=(xy,Ly,0), c=(xz,yz,Lz)
    step: jax.Array     # int32 scalar timestep counter

    @property
    def cap(self) -> int:
        return self.x.shape[0]

    @property
    def n_active(self):
        return jnp.sum(self.active.astype(jnp.int32))


@struct.dataclass
class Shapes:
    """Static per-shape-type data, precomputed at setup (SURVEY.md 7.2 s2).

    The per-type SH coefficient tables plus everything derived from them:
    quadrature-node radii/normals in the body frame, radius interpolation
    tables, bounding radii, volume and principal inertia at unit scale.
    ``lmax`` is static metadata (drives unrolled recurrences).
    """

    lmax: int = struct.field(pytree_node=False)
    coeffs: jax.Array        # [T, (lmax+1)^2] real SH coefficients
    quad_theta: jax.Array    # [G]
    quad_phi: jax.Array      # [G]
    quad_w: jax.Array        # [G] solid-angle weights (sum 4 pi)
    quad_dirs: jax.Array     # [G, 3] unit directions (body frame)
    node_r: jax.Array        # [T, G] body-frame radius at each node
    node_normals: jax.Array  # [T, G, 3] body-frame outward unit normals
    node_area: jax.Array     # [T, G] area element w * r^2 / (n . rhat)
    table: jax.Array         # [T, 3, nt, np] (r, dr/dt, dr/dp) interp tables
    rmax: jax.Array          # [T] bounding-sphere radius (unit scale)
    rmin: jax.Array          # [T] inscribed-sphere radius (unit scale)
    rchar: jax.Array         # [T] mean radius a_00/sqrt(4pi) (Hertz R_eff)
    # Patch-local contact quadrature: GL x azimuth grid over the spherical
    # cap facing the contact (flattened [Gc]); cap_x in (0,1) maps to
    # cos(gamma) = 1 - (1 - cos(gamma_max)) * cap_x per pair at runtime.
    cap_x: jax.Array         # [Gc] GL nodes mapped to (0, 1)
    cap_glw: jax.Array       # [Gc] GL weights (sum over gamma block = 1)
    cap_cpsi: jax.Array      # [Gc] cos(psi) azimuth
    cap_spsi: jax.Array      # [Gc] sin(psi)
    # Coarse cap grid of the rebuild-time prefilter: a cheap r-only
    # containment probe on these nodes culls the ~70-90% of bounding-
    # sphere candidates that are not actually touching, so the full
    # gradient evaluation on the fine cap grid runs only on survivors.
    cap1_x: jax.Array        # [G1]
    cap1_glw: jax.Array      # [G1]
    cap1_cpsi: jax.Array     # [G1]
    cap1_spsi: jax.Array     # [G1]
    vol: jax.Array           # [T] volume (unit scale, unit density)
    inertia: jax.Array       # [T, 3] principal inertia (unit scale/density)
    density: jax.Array       # [T] mass density
    # Power-basis (monomial) tables (ops/sh_power.py): coefficients
    # absorbed into per-type per-m Horner runs, ~3x fewer FLOPs per node
    # than the streaming ALP chain. The rebuild-time prefilter probe
    # evaluates r from the A/B prefix of power_tbl.
    power_tbl: jax.Array     # [T, W(lmax)] full r/drt/drp Horner tables
    # Max tangential surface gradient |grad_tang r| (unit scale): bounds
    # the radial surface motion under body rotation (rotation-aware
    # neighbor/prefilter skin trigger; 0 for spheres).
    gmax: jax.Array          # [T]

    @property
    def n_types(self) -> int:
        return self.coeffs.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.quad_theta.shape[0]

    def mass_of(self, shtype, scale):
        return self.density[shtype] * self.vol[shtype] * scale**3

    def inertia_of(self, shtype, scale):
        return (
            self.density[shtype, None]
            * self.inertia[shtype]
            * (scale**5)[..., None]
        )


@struct.dataclass
class NeighborState:
    """Fixed-capacity Verlet neighbor tensor + contact history.

    Fixed-shape replacement for the reference's NeighList pages + granular
    contact-history fix (SURVEY.md section 2 B.3). ``idx`` is a FULL list:
    pair (i, j) appears in both rows, so force accumulation is a pure
    per-row reduction with no scatter (Newton handled by antisymmetry).
    """

    idx: jax.Array      # [cap, K] int32 neighbor slot indices (0 if invalid)
    mask: jax.Array     # [cap, K] bool validity
    hist: jax.Array     # [cap, K, HW] tangential (+rolling) spring state
                        # (world). With a pair list active this is the
                        # REBUILD-TIME snapshot (the durable, tag-keyed
                        # representation); between rebuilds the live
                        # springs ride in pair_hist.
    neigh_tag: jax.Array  # [cap, K] int32 neighbor TAGS at build time — the
                          # stable key for carrying history across rebuilds
                          # (slot ids shuffle under sharding/migration)
    row_tag: jax.Array    # [cap] int32 owner tag of each row at build time
    wall_hist: jax.Array  # [cap, W, HW] per-wall springs
    x_build: jax.Array  # [cap, 3] positions at build time (skin trigger)
    q_build: jax.Array  # [cap, 4] orientations at build time (rotation-
                        # aware trigger for the prefiltered pair list:
                        # surface approach <= disp + gmax * rot_angle)
    budget: jax.Array   # [cap] per-particle motion budget recorded by the
                        # rebuild-time prefilter (contact.prefilter_pair_list):
                        # the kept pair list stays complete while every
                        # particle's surface motion <= its budget
                        # (ops.neighbor.approach_ratio)
    overflow: jax.Array # int32: max candidate count seen (> K means trouble)
    skin_violations: jax.Array  # int32: times displacement exceeded skin/2
                                # before a static-cadence rebuild fired

    # Stable pair list, compacted ONCE per rebuild from the [cap, K]
    # Verlet tensor (LAMMPS's actual structure: the pair loop runs over
    # a half neighbor list built at reneighbor time, not re-derived per
    # step). Valid until the next rebuild because candidates keep the
    # full skin margin (dist_build < rb_i + rb_j + skin).
    pair_i: jax.Array     # [Pc] int32 row slot (sorted ascending)
    pair_j: jax.Array     # [Pc] int32 partner slot (may be a ghost slot)
    pair_valid: jax.Array # [Pc] bool
    pair_both: jax.Array  # [Pc] bool: apply the reaction to j too (half-
                          # list owned-owned pair); False = one-sided
                          # owned-ghost pair (the ghost's owner shard
                          # evaluates the mirror copy)
    pair_hist: jax.Array  # [Pc, HW] live tangential(+rolling) springs
    pair_sel: jax.Array   # [Pc] int32 flat cap*K slot of the (i->j) entry
                          # (for the rebuild-time scatter-back); cap*K = none
    pair_selj: jax.Array  # [Pc] int32 flat slot of the mirror (j->i) entry
    pair_jsort: jax.Array # [Pc] int32 permutation sorting pair_j (so the
                          # j-side reaction sum is a sorted segment_sum)

    @property
    def k_max(self) -> int:
        return self.idx.shape[1]

    @property
    def pair_cap(self) -> int:
        return self.pair_i.shape[0]


@struct.dataclass
class SimParams:
    """Physics + integration parameters (all traced leaves: no recompiles).

    Contact law follows LAMMPS pair_style gran/hertz/history
    (SURVEY.md 2 B.4): with overlap delta, effective radius R_eff and
    effective mass m_eff,

      poly = sqrt(delta * R_eff)
      F_n  = poly * (kn * delta - m_eff * gamma_n * v_n)
      F_t  = -poly * (kt * xi + m_eff * gamma_t * v_t),  |F_t| <= mu |F_n|

    Optional rolling resistance (LAMMPS granular ``rolling sds``
    spring-dashpot-slider; config 4 "friction + rolling"):

      v_roll = -R_eff * (n x (omega_i - omega_j))
      F_r    = -k_roll * xi_r - gamma_roll * v_roll, |F_r| <= mu_roll |F_n|
      tau_i += R_eff * (n x F_r);  tau_j -= R_eff * (n x F_r)

    (a pure torque pair — no center force). k_roll = gamma_roll = 0
    disables the model.
    """

    dt: jax.Array
    kn: jax.Array
    kt: jax.Array
    gamma_n: jax.Array
    gamma_t: jax.Array
    mu: jax.Array
    k_roll: jax.Array
    gamma_roll: jax.Array
    mu_roll: jax.Array
    gravity: jax.Array       # [3]
    skin: jax.Array          # Verlet skin distance
    cutoff: jax.Array        # neighbor cutoff = 2*max(rmax*scale) (+ margin)
    deform_rate: jax.Array   # [3] diagonal engineering strain rate (fix
                             # deform analogue; triaxial cell of config 5)
    shear_rate: jax.Array    # [3] off-diagonal engineering shear rates
                             # (d vx/dy, d vx/dz, d vy/dz): grows the
                             # (xy, xz, yz) tilt (fix deform xy/xz/yz)
    press_target: jax.Array  # [3] target diagonal stress (servo control)
    press_tau: jax.Array     # Berendsen coupling time; 0 disables servo
    # Per-type-pair material table [T, T, 8] holding (kn, kt, gamma_n,
    # gamma_t, mu, k_roll, gamma_roll, mu_roll) per (type_i, type_j) —
    # the LAMMPS ``pair_coeff i j ...`` surface (SURVEY.md 2 B.4 Pair
    # base "mixing"). create() emits a [1, 1, 8] broadcast of the global
    # scalars (single-material decks pay nothing); with_pair_coeffs
    # builds a full table with geometric mixing for unset off-diagonal
    # pairs. The scalar fields above remain the wall-law coefficients
    # and the mixing defaults.
    pair_tab: jax.Array

    @classmethod
    def create(cls, dt, kn, kt=None, gamma_n=0.0, gamma_t=None, mu=0.5,
               k_roll=0.0, gamma_roll=0.0, mu_roll=0.0,
               gravity=(0.0, 0.0, 0.0), skin=0.0, cutoff=1.0,
               deform_rate=(0.0, 0.0, 0.0), shear_rate=(0.0, 0.0, 0.0),
               press_target=(0.0, 0.0, 0.0), press_tau=0.0,
               dtype=jnp.float32):
        if kt is None:
            kt = 2.0 / 7.0 * kn
        if gamma_t is None:
            gamma_t = 0.5 * gamma_n
        f = lambda x: jnp.asarray(x, dtype=dtype)
        pair_tab = jnp.stack(
            [f(kn), f(kt), f(gamma_n), f(gamma_t), f(mu),
             f(k_roll), f(gamma_roll), f(mu_roll)]
        ).reshape(1, 1, 8)
        return cls(
            dt=f(dt), kn=f(kn), kt=f(kt), gamma_n=f(gamma_n),
            gamma_t=f(gamma_t), mu=f(mu),
            k_roll=f(k_roll), gamma_roll=f(gamma_roll), mu_roll=f(mu_roll),
            gravity=f(jnp.asarray(gravity)),
            skin=f(skin), cutoff=f(cutoff),
            deform_rate=f(jnp.asarray(deform_rate)),
            shear_rate=f(jnp.asarray(shear_rate)),
            press_target=f(jnp.asarray(press_target)),
            press_tau=f(press_tau),
            pair_tab=pair_tab,
        )

    def with_pair_coeffs(self, n_types: int, coeffs: dict):
        """Per-type-pair material table from explicit ``pair_coeff i j``
        entries (0-based type indices, i <= j or any order; values are
        (kn, kt, gamma_n, gamma_t, mu[, k_roll, gamma_roll, mu_roll])).

        Unset diagonal entries default to the global scalars; unset
        off-diagonal (i, j) mix GEOMETRICALLY from the diagonals:
        sqrt(c_ii * c_jj) componentwise (the LAMMPS granular `mix
        geometric` convention; zero disables a component for the pair
        exactly when either material has it disabled)."""
        import numpy as np

        diag_default = np.array([
            float(self.kn), float(self.kt), float(self.gamma_n),
            float(self.gamma_t), float(self.mu), float(self.k_roll),
            float(self.gamma_roll), float(self.mu_roll),
        ])
        tab = np.zeros((n_types, n_types, 8))
        have = np.zeros((n_types, n_types), bool)
        for (i, j), vals in coeffs.items():
            v = np.asarray([float(x) for x in vals])
            if v.shape[0] == 5:
                v = np.concatenate([v, np.zeros(3)])
            if v.shape[0] != 8:
                raise ValueError(
                    f"pair_coeff needs 5 or 8 values, got {v.shape[0]}"
                )
            tab[i, j] = tab[j, i] = v
            have[i, j] = have[j, i] = True
        for i in range(n_types):
            if not have[i, i]:
                tab[i, i] = diag_default
                have[i, i] = True
        for i in range(n_types):
            for j in range(i + 1, n_types):
                if not have[i, j]:
                    tab[i, j] = tab[j, i] = np.sqrt(tab[i, i] * tab[j, j])
        return self.replace(pair_tab=jnp.asarray(tab, self.kn.dtype))


def pair_material(params: SimParams, t_i, t_j):
    """Gather per-pair material rows [..., 8] = (kn, kt, gamma_n,
    gamma_t, mu, k_roll, gamma_roll, mu_roll) from the [T, T, 8] table.
    Indices clamp to the table size, so the [1, 1, 8] scalar-broadcast
    default serves any number of shape types."""
    tp = params.pair_tab.shape[0]
    ti = jnp.minimum(t_i, tp - 1)
    tj = jnp.minimum(t_j, tp - 1)
    return params.pair_tab[ti, tj]


def zeros_state(cap: int, box_lo, box_hi, dtype=jnp.float32) -> State:
    """An empty fixed-capacity State (all slots inactive)."""
    q0 = jnp.zeros((cap, 4), dtype)
    q0 = q0.at[:, 0].set(1.0)
    return State(
        x=jnp.zeros((cap, 3), dtype),
        v=jnp.zeros((cap, 3), dtype),
        q=q0,
        angmom=jnp.zeros((cap, 3), dtype),
        f=jnp.zeros((cap, 3), dtype),
        tau=jnp.zeros((cap, 3), dtype),
        scale=jnp.ones((cap,), dtype),
        shtype=jnp.zeros((cap,), jnp.int32),
        tag=jnp.zeros((cap,), jnp.int32),
        active=jnp.zeros((cap,), bool),
        image=jnp.zeros((cap, 3), jnp.int32),
        box_lo=jnp.asarray(box_lo, dtype),
        box_hi=jnp.asarray(box_hi, dtype),
        tilt=jnp.zeros((3,), dtype),
        step=jnp.asarray(0, jnp.int32),
    )


# Width of the per-contact spring state: 3 tangential + 3 rolling.
HIST_W = 6


def empty_neighbors(cap: int, k_max: int, n_walls: int = 0,
                    dtype=jnp.float32, pair_cap: int = 0) -> NeighborState:
    return NeighborState(
        idx=jnp.zeros((cap, k_max), jnp.int32),
        mask=jnp.zeros((cap, k_max), bool),
        hist=jnp.zeros((cap, k_max, HIST_W), dtype),
        neigh_tag=jnp.zeros((cap, k_max), jnp.int32),
        row_tag=jnp.zeros((cap,), jnp.int32),
        wall_hist=jnp.zeros((cap, max(n_walls, 1), HIST_W), dtype),
        x_build=jnp.zeros((cap, 3), dtype),
        q_build=jnp.zeros((cap, 4), dtype).at[:, 0].set(1.0),
        budget=jnp.zeros((cap,), dtype),
        overflow=jnp.asarray(0, jnp.int32),
        skin_violations=jnp.asarray(0, jnp.int32),
        pair_i=jnp.zeros((pair_cap,), jnp.int32),
        pair_j=jnp.zeros((pair_cap,), jnp.int32),
        pair_valid=jnp.zeros((pair_cap,), bool),
        pair_both=jnp.zeros((pair_cap,), bool),
        pair_hist=jnp.zeros((pair_cap, HIST_W), dtype),
        pair_sel=jnp.full((pair_cap,), cap * k_max, jnp.int32),
        pair_selj=jnp.full((pair_cap,), cap * k_max, jnp.int32),
        pair_jsort=jnp.zeros((pair_cap,), jnp.int32),
    )
