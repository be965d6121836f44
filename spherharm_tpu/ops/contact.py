"""SH contact narrow phase + Hertz/friction force law — THE hot path.

Array-program re-design of the reference's SH contact pair style
(SURVEY.md section 2 B.4 / 3.3; capability contract BASELINE.json:5:
"pairwise contact hot path (associated-Legendre/Ylm recurrences, radius
evaluation on Gauss-Legendre quadrature grids, overlap-volume and
contact-normal surface integrals), Hertz/friction force and torque
accumulation"). Instead of a per-pair C++ double loop, everything is a
batched tensor program over ``[P, G]`` (pairs x quadrature nodes).

Method (both-sides symmetric, Newton's third law by construction):

  for each candidate pair (i, j):
    build a PATCH-LOCAL Gauss-Legendre grid over the spherical cap of
    i's surface that can geometrically reach j's bounding sphere
    (half-angle gamma_max from the tangent-cone bound; the cap — and
    with it the node density — shrinks to the contact point as the
    overlap shrinks: adaptive resolution, SURVEY.md 7.3 "patch-local
    quadrature"). For each cap node k:
    p_k   = x_i + R(q_i) (s_i r_i(dir_k) dir_k)      # world node position
    u_k   = R(q_j)^T (p_k - x_j);  rho_k = |u_k|     # into j's body frame
    r_jk  = s_j * r_j(theta'_k, phi'_k)              # radius of j there
    inside_k = rho_k < r_jk;   depth_k = r_jk - rho_k
  (and the mirrored pass with i/j swapped)

  S1 = sum dA * depth           (overlap volume measure, both sides)
  S2 = sum dA * depth^2         (second depth moment)
  c  = depth-volume-weighted contact centroid (both sides)
  n  = normalized depth-weighted mean of the *other* particle's outward
       surface normal (points from j toward i)
  delta = 1.5 * S2 / S1         # smooth overlap depth; EXACT for the
                                # sphere-sphere lens (paraboloid depth
                                # profile has S2/S1 = (2/3) delta), and
                                # C^1 in the separation with NO
                                # containment indicator (kink-free:
                                # integrands vanish at the patch rim)

  Hertz + history friction (LAMMPS gran/hertz/history law):
    poly = sqrt(delta * R_eff)
    F_n  = poly * (kn * delta) * n  -  poly * m_eff * gamma_n * v_n
    xi  += v_t * dt  (projected tangent);  F_t = -poly*(kt*xi + m_eff*gamma_t*v_t)
    |F_t| <= mu |F_n|  (Coulomb cap, spring rescaled on saturation)
    tau_i += (c - x_i) x F;  equal/opposite on j via the full neighbor list.

The smooth depth-moment overlap (instead of max node depth or an
indicator-based area) is the key numerical choice: forces are smooth
functions of the geometry, so node-discretization noise and
node-crossing kinks (which velocity-Verlet rectifies into energy drift)
are absent by construction.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from spherharm_tpu.core import state as state_mod
from spherharm_tpu.ops import rotation, sh_math, sh_power
from spherharm_tpu.ops.rotation import (
    angles_from_unit,
    quat_rotate,
    quat_rotate_inv,
)


def minimum_image(d, box_lo, box_hi, periodic, tilt=None):
    """Minimum-image displacement for periodic dims (static flags).

    ``tilt`` = (xy, xz, yz) triclinic tilt factors (box edge vectors
    a=(Lx,0,0), b=(xy,Ly,0), c=(xz,yz,Lz)). With tilt, images are
    removed sequentially c -> b -> a (valid for |tilt| <= L/2, the
    LAMMPS bound). tilt=None compiles to the orthogonal fast path.
    """
    L = box_hi - box_lo
    pmask = jnp.asarray(periodic, dtype=d.dtype)
    if tilt is None:
        shift = jnp.round(d / L) * L
        return d - shift * pmask
    xy, xz, yz = tilt[0], tilt[1], tilt[2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    n3 = jnp.round(dz / L[2]) * pmask[2]
    dx = dx - n3 * xz
    dy = dy - n3 * yz
    dz = dz - n3 * L[2]
    n2 = jnp.round(dy / L[1]) * pmask[1]
    dx = dx - n2 * xy
    dy = dy - n2 * L[1]
    n1 = jnp.round(dx / L[0]) * pmask[0]
    dx = dx - n1 * L[0]
    return jnp.stack([dx, dy, dz], axis=-1)


def unshear_coords(x, box_lo, box_hi, tilt):
    """Map positions to the unsheared (orthogonalized) frame.

    x' = lo + L * frac(x) with frac = H^-1 (x - lo) via back-substitution
    through the upper-triangular cell matrix H = [a|b|c]. Periodic
    images are exact orthogonal translations of these coordinates, so
    cell binning stays correct under tilt (size cells with a
    tilt-inflated cutoff; the distance filter itself uses the exact
    triclinic minimum image).
    """
    L = box_hi - box_lo
    f3 = (x[..., 2] - box_lo[2]) / L[2]
    f2 = (x[..., 1] - box_lo[1] - tilt[2] * f3) / L[1]
    xp = x[..., 0] - tilt[0] * f2 - tilt[1] * f3
    yp = box_lo[1] + L[1] * f2
    return jnp.stack([xp, yp, x[..., 2]], axis=-1)


def eval_radius(shapes, types, theta, phi, exact: bool):
    """Per-unit-scale radius + angular gradients of given shape types.

    types: [P], theta/phi: [P, G]. Returns (r, dr_dt, dr_dp) each [P, G].
    Exact path: unrolled ALP/Ylm recurrences + coefficient contraction
    (BASELINE.json:5 "associated-Legendre/Ylm recurrences"); table path:
    bilinear lookup in the precomputed (r, dr_dt, dr_dp) tables.
    """
    if exact:
        c = shapes.coeffs[types]  # [P, NC]
        return sh_math.radius_grad_streaming(c, theta, phi, shapes.lmax)
    return sh_math.interp_radius_batched(shapes.table, types, theta, phi)


def _unit_trig(u):
    """(cos t, sin t, cos p, sin p) of unit vectors u[..., 3] — no angles.

    Saves arccos/arctan2 + sin/cos per node (4+ transcendentals) in the
    hot loop.
    """
    ct = jnp.clip(u[..., 2], -1.0, 1.0)
    st = jnp.sqrt(jnp.maximum(u[..., 0] ** 2 + u[..., 1] ** 2, 1e-24))
    inv = 1.0 / jnp.maximum(st, 1e-12)
    return ct, st, u[..., 0] * inv, u[..., 1] * inv


def eval_radius_trig(shapes, types, ct, st, cp, sp, exact: bool):
    """Trig-component twin of eval_radius."""
    if exact:
        c = shapes.coeffs[types]
        return sh_math.radius_grad_streaming_trig(c, ct, st, cp, sp,
                                                  shapes.lmax)
    theta = jnp.arccos(ct)
    phi = jnp.arctan2(sp, cp)
    return sh_math.interp_radius_batched(shapes.table, types, theta, phi)


def _orthobasis(e):
    """Two unit vectors orthogonal to unit e [...,3]."""
    h = jnp.where(
        (jnp.abs(e[..., 0:1]) < 0.9),
        jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], e.dtype), e.shape),
        jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0], e.dtype), e.shape),
    )
    t1 = jnp.cross(e, h)
    t1 = t1 / jnp.linalg.norm(t1, axis=-1, keepdims=True).clip(1e-12)
    t2 = jnp.cross(e, t1)
    return t1, t2


def surface_probe(qi, si, type_i, qj, sj, type_j,
                  rb_j, rm_i, rb_i, rc_j, d, shapes, exact: bool,
                  incl: bool = True):
    """One-sided probe: i's cap-local surface nodes tested against j.

    ``incl``: include the 1/cos(inclination) factor in the measure
    (true surface area). Conservative mode uses ``incl=False`` (solid-
    angle measure r^2 dOmega): ANY fixed smooth measure yields an
    exactly conservative force when the PE is differentiated, and the
    inclination-free measure needs only r and its FIRST angular
    derivatives in the gradient (cheap to hand-derive). The depth-moment ratio S2/S1 (and with it the
    overlap depth) is measure-normalized, so the physics difference is
    O(patch tilt), negligible at contact overlaps.

    All args are per-pair (leading dim P); rb/rm/rc are the pre-scaled
    bounding / inscribed / characteristic radii (so no per-pair shape
    table lookups happen here). ``d`` is the
    minimum-image x_j - x_i. Builds the adaptive cap grid on i facing j,
    evaluates i's own radius there, transforms into j's frame, tests
    containment.

    Returns per-pair integrals:
      area [P], vol [P], centroid_num [P,3] (area-weighted, relative to
      x_i), normal_num [P,3] (area-weighted outward normals of j, world),
      max_depth [P].
    """
    dist = jnp.linalg.norm(d, axis=-1)
    inv_dist = 1.0 / jnp.maximum(dist, 1e-12)
    e_world = d * inv_dist[..., None]
    e_body = quat_rotate_inv(qi, e_world)  # contact axis in i's body frame

    # Cap half-angle: largest polar angle (from e_body) at which a point of
    # i's surface (radius in [rmin_i, rmax_i]) can lie inside j's bounding
    # sphere of radius Rj at distance dist. Law of cosines, minimized over
    # the radial interval (optimum at rho* = sqrt(dist^2 - Rj^2)).
    Rj = rb_j
    # Double-where sqrt guard: at dist < Rj the dead sqrt(0) branch
    # otherwise NaNs the autodiff gradient of the whole pair (the
    # conservative mode would silently zero the elastic force for
    # deeply bounding-overlapping pairs).
    rho2 = dist**2 - Rj**2
    rho_star = jnp.where(
        rho2 > 0, jnp.sqrt(jnp.where(rho2 > 0, rho2, 1.0)), 0.0
    )
    rho_c = jnp.clip(rho_star, rm_i, rb_i)
    cos_gmax = (rho_c**2 + dist**2 - Rj**2) / jnp.maximum(
        2.0 * rho_c * dist, 1e-12
    )
    cos_gmax = jnp.clip(cos_gmax, -1.0, 1.0 - 1e-6)

    # Cap node directions in i's body frame: [P, Gc, 3].
    one_m = (1.0 - cos_gmax)[..., None]  # [P,1]
    cos_g = 1.0 - one_m * shapes.cap_x[None, :]
    # Positive floor keeps the sqrt gradient finite at cos_g -> -1
    # (full-sphere cap when the clip's -1 bound engages).
    sin_g = jnp.sqrt(jnp.maximum(1.0 - cos_g**2, 1e-12))
    t1, t2 = _orthobasis(e_body)
    dirs = (
        cos_g[..., None] * e_body[..., None, :]
        + (sin_g * shapes.cap_cpsi)[..., None] * t1[..., None, :]
        + (sin_g * shapes.cap_spsi)[..., None] * t2[..., None, :]
    )
    ct_i, st_i, cp_i, sp_i = _unit_trig(dirs)

    # i's own surface at the cap nodes.
    r_i, drt_i, drp_i = eval_radius_trig(
        shapes, type_i, ct_i, st_i, cp_i, sp_i, exact
    )
    r_i = r_i * si[..., None]
    n_i = sh_math.surface_normal_trig(
        r_i, drt_i * si[..., None], drp_i * si[..., None],
        ct_i, st_i, cp_i, sp_i,
    )
    w_solid = one_m * shapes.cap_glw[None, :]  # dOmega weights
    if incl:
        cos_incl = jnp.clip(jnp.sum(n_i * dirs, axis=-1), 0.05, 1.0)
        dA = w_solid * r_i**2 / cos_incl
    else:
        dA = w_solid * r_i**2

    # World positions (relative to x_i) and j-frame containment test.
    rel_i = quat_rotate(qi[..., None, :], r_i[..., None] * dirs)
    u = quat_rotate_inv(qj[..., None, :], rel_i - d[..., None, :])
    rho = jnp.linalg.norm(u, axis=-1)
    u_hat = u / jnp.maximum(rho, 1e-12)[..., None]
    ct_j, st_j, cp_j, sp_j = _unit_trig(u_hat)
    r_j, drt_j, drp_j = eval_radius_trig(
        shapes, type_j, ct_j, st_j, cp_j, sp_j, exact
    )
    r_j = r_j * sj[..., None]

    # Depth-moment overlap integrals. No containment indicator at all:
    # the integrands (depth, depth^2) vanish smoothly at the patch rim,
    # so the sums are C^1 in the separation — a hard inside/outside
    # indicator made the force kink whenever a node crossed the surface
    # and velocity-Verlet rectified that into systematic energy gain
    # (measured +1e-3/collision); a smoothstep fix traded it for a
    # w/delta force bias. The depth moments have neither. The overlap
    # depth is recovered downstream as delta = 1.5*S2/S1, which is EXACT
    # for the sphere-sphere lens (paraboloid depth profile:
    # S2/S1 = (2/3) delta).
    depth = jnp.maximum(r_j - rho, 0.0)
    wd = dA * depth
    s1 = jnp.sum(wd, axis=-1)               # = overlap volume measure
    s2 = jnp.sum(wd * depth, axis=-1)
    centroid_num = jnp.sum(wd[..., None] * rel_i, axis=-2)  # rel to x_i

    # Outward normal of j at the probe points, j body frame -> world.
    n_body = sh_math.surface_normal_trig(
        r_j, drt_j * sj[..., None], drp_j * sj[..., None],
        ct_j, st_j, cp_j, sp_j,
    )
    n_world = quat_rotate(qj[..., None, :], n_body)
    normal_num = jnp.sum(wd[..., None] * n_world, axis=-2)

    return s1, s2, centroid_num, normal_num, jnp.max(depth, axis=-1)


# Packed per-particle row layout (one row-gather per pair side instead
# of ~15 per-field gathers). Columns:
ROW_W = 20
_RX, _RV, _RQ, _ROM = slice(0, 3), slice(3, 6), slice(6, 10), slice(10, 13)
_RM_, _RRB, _RRM, _RRC, _RS, _RACT = 13, 14, 15, 16, 17, 18


def particle_rows(state, shapes, active=None):
    """Pack the per-particle data the pair kernel needs into [N, ROW_W].

    Computed ONCE per step (elementwise; omega per particle instead of
    per pair); pair access becomes two contiguous row-gathers.
    """
    om = rotation.omega_from_angmom(
        state.q, state.angmom,
        shapes.inertia_of(state.shtype, state.scale),
    )
    m = shapes.mass_of(state.shtype, state.scale)
    s = state.scale
    if active is None:
        active = state.active
    cols = [
        state.x, state.v, state.q, om, m[:, None],
        (shapes.rmax[state.shtype] * s)[:, None],
        (shapes.rmin[state.shtype] * s)[:, None],
        (shapes.rchar[state.shtype] * s)[:, None],
        s[:, None],
        active[:, None],
    ]
    rows = jnp.concatenate([c.astype(state.x.dtype) for c in cols], axis=1)
    return jnp.pad(rows, ((0, 0), (0, ROW_W - rows.shape[1])))


@partial(jax.jit,
         static_argnames=("exact", "periodic", "conservative"))
def pair_contact_rows(rows_i, rows_j, t_i, t_j, hist, pair_mask,
                      box_lo, box_hi, shapes, params,
                      exact: bool = False, periodic=(False, False, False),
                      tilt=None, conservative: bool = False):
    """Full contact law for a batch of P candidate pairs (row inputs).

    Returns (force_on_i [P,3], torque_on_i [P,3], torque_on_j [P,3],
    new_hist [P,3], pe [P], in_contact [P], rij [P,3]). The force on j
    is -force_on_i (Newton); torque_on_j is reported separately because
    it uses j's own moment arm (and, later, rolling pure torques).
    """
    x_i, v_i, q_i, om_i = (rows_i[:, _RX], rows_i[:, _RV],
                           rows_i[:, _RQ], rows_i[:, _ROM])
    x_j, v_j, q_j, om_j = (rows_j[:, _RX], rows_j[:, _RV],
                           rows_j[:, _RQ], rows_j[:, _ROM])
    m_i, m_j = rows_i[:, _RM_], rows_j[:, _RM_]
    rb_i, rb_j = rows_i[:, _RRB], rows_j[:, _RRB]
    rm_i, rm_j = rows_i[:, _RRM], rows_j[:, _RRM]
    rc_i, rc_j = rows_i[:, _RRC], rows_j[:, _RRC]
    s_i, s_j = rows_i[:, _RS], rows_j[:, _RS]

    d = minimum_image(x_j - x_i, box_lo, box_hi, periodic, tilt)
    dist = jnp.linalg.norm(d, axis=-1)
    rsum = rb_i + rb_j
    cull = pair_mask & (dist < rsum) & (dist > 1e-12)

    # Both-sided probes (i's nodes in j, j's nodes in i). Conservative
    # mode uses the inclination-free measure (see surface_probe) so the
    # geometric aux (delta, centroid, normal) matches the PE gradient's
    # measure exactly.
    s1a, s2a, c1, n1, dep1 = surface_probe(
        q_i, s_i, t_i, q_j, s_j, t_j, rb_j, rm_i, rb_i, rc_j,
        d, shapes, exact, incl=not conservative
    )
    s1b, s2b, c2, n2, dep2 = surface_probe(
        q_j, s_j, t_j, q_i, s_i, t_i, rb_i, rm_j, rb_j, rc_i,
        -d, shapes, exact, incl=not conservative
    )
    s1 = s1a + s1b
    s2 = s2a + s2b
    # centroid relative to x_i: c1 is; (c2 + s1b*d) maps j-rel to i-rel.
    centroid = jnp.where(
        (s1 > 0)[..., None],
        (c1 + c2 + s1b[..., None] * d) / jnp.maximum(s1, 1e-30)[..., None],
        0.5 * d,
    )
    # Normal pointing from j toward i: j's outward normals (n1) minus i's (n2).
    n_raw = n1 - n2
    n_norm = jnp.linalg.norm(n_raw, axis=-1, keepdims=True)
    d_hat = d / jnp.maximum(dist, 1e-12)[..., None]
    n_hat = jnp.where(n_norm > 1e-20, n_raw / jnp.maximum(n_norm, 1e-30), -d_hat)

    in_contact = cull & (s1 > 0)
    # Lens-exact smooth overlap depth from the depth moments.
    delta = jnp.where(in_contact, 1.5 * s2 / jnp.maximum(s1, 1e-30), 0.0)

    r_eff = rc_i * rc_j / jnp.maximum(rc_i + rc_j, 1e-12)
    m_eff = m_i * m_j / jnp.maximum(m_i + m_j, 1e-30)
    poly = jnp.sqrt(jnp.maximum(delta * r_eff, 0.0))

    # Relative velocity of i w.r.t. j at the contact point.
    arm_i = centroid
    arm_j = centroid - d
    v_rel = (
        v_i + jnp.cross(om_i, arm_i) - v_j - jnp.cross(om_j, arm_j)
    )
    vn_mag = jnp.sum(v_rel * n_hat, axis=-1)
    vn = vn_mag[..., None] * n_hat
    vt = v_rel - vn

    # Per-type-pair material coefficients (LAMMPS pair_coeff i j ...;
    # the [1, 1, 8] default broadcasts the global scalars).
    mat = state_mod.pair_material(params, t_i, t_j)
    kn_p, kt_p, gn_p, gt_p = (mat[..., 0], mat[..., 1],
                              mat[..., 2], mat[..., 3])
    mu_p, krl_p, grl_p, murl_p = (mat[..., 4], mat[..., 5],
                                  mat[..., 6], mat[..., 7])

    fn_mag = poly * (
        kn_p * delta - m_eff * gn_p * vn_mag
    )
    fn_mag = jnp.maximum(fn_mag, 0.0)  # contact cannot pull
    f_n = fn_mag[..., None] * n_hat

    # Tangential history spring (world frame), projected tangent each step.
    xi = hist[..., 0:3]
    xi = xi - jnp.sum(xi * n_hat, axis=-1, keepdims=True) * n_hat
    xi = jnp.where(in_contact[..., None], xi + vt * params.dt, 0.0)
    f_t = -(poly[..., None]) * (kt_p[..., None] * xi
                                + (m_eff * gt_p)[..., None] * vt)
    ft_mag = jnp.linalg.norm(f_t, axis=-1)
    cap = mu_p * fn_mag
    over = ft_mag > jnp.maximum(cap, 1e-30)
    scale_ft = jnp.where(over, cap / jnp.maximum(ft_mag, 1e-30), 1.0)
    f_t = f_t * scale_ft[..., None]
    # Rescale the stored spring consistently on saturation (LAMMPS-style).
    xi = jnp.where(
        (over & (poly > 0))[..., None],
        -(f_t / jnp.maximum(poly, 1e-30)[..., None]
          + (m_eff * gt_p)[..., None] * vt)
        / jnp.maximum(kt_p, 1e-30)[..., None],
        xi,
    )

    # Rolling resistance (spring-dashpot-slider; see SimParams docstring).
    # Symmetric under pair-direction swap: v_roll(j,i) == v_roll(i,j).
    roll_on = (krl_p > 0) | (grl_p > 0)
    v_roll = -r_eff[..., None] * jnp.cross(n_hat, om_i - om_j)
    xi_r = hist[..., 3:6]
    xi_r = xi_r - jnp.sum(xi_r * n_hat, axis=-1, keepdims=True) * n_hat
    xi_r = jnp.where(
        (in_contact & roll_on)[..., None], xi_r + v_roll * params.dt, 0.0
    )
    f_r = -(krl_p[..., None] * xi_r + grl_p[..., None] * v_roll)
    fr_mag = jnp.linalg.norm(f_r, axis=-1)
    cap_r = murl_p * fn_mag
    over_r = fr_mag > jnp.maximum(cap_r, 1e-30)
    f_r = f_r * jnp.where(
        over_r, cap_r / jnp.maximum(fr_mag, 1e-30), 1.0
    )[..., None]
    xi_r = jnp.where(
        (over_r & (krl_p > 0))[..., None],
        -(f_r + grl_p[..., None] * v_roll)
        / jnp.maximum(krl_p, 1e-30)[..., None],
        xi_r,
    )
    tau_roll = r_eff[..., None] * jnp.cross(n_hat, f_r)
    tau_roll = jnp.where(in_contact[..., None], tau_roll, 0.0)

    if conservative:
        # Replace the geometric elastic normal force + its moment-arm
        # torques with the exact gradient of the sampled PE (energy-
        # conserving by construction; see pair_elastic_grad). Damping,
        # friction and rolling stay geometric — they are dissipative by
        # design and need no potential.
        f_el, tau_el_i, tau_el_j = pair_elastic_grad(
            rows_i, rows_j, t_i, t_j, pair_mask,
            box_lo, box_hi, shapes, params, exact, periodic, tilt,
        )
        fn_damp = -(poly * m_eff * gn_p * vn_mag)
        f_vis = jnp.where(
            in_contact[..., None], fn_damp[..., None] * n_hat + f_t, 0.0
        )
        force = f_el + f_vis
        torque = tau_el_i + jnp.cross(arm_i, f_vis) + tau_roll
        torque_j = tau_el_j + jnp.cross(arm_j, -f_vis) - tau_roll
        xi = jnp.concatenate([xi, xi_r], axis=-1)
        pe = jnp.where(
            in_contact,
            0.4 * kn_p * jnp.sqrt(r_eff) * delta**2.5,
            0.0,
        )
        return force, torque, torque_j, xi, pe, in_contact, d

    force = jnp.where(in_contact[..., None], f_n + f_t, 0.0)
    torque = jnp.cross(arm_i, force) + tau_roll
    torque_j = jnp.cross(arm_j, -force) - tau_roll
    xi = jnp.concatenate([xi, xi_r], axis=-1)
    # Elastic PE of the Hertzian spring: integral kn*sqrt(R)*d^{3/2} dd.
    pe = jnp.where(
        in_contact,
        0.4 * kn_p * jnp.sqrt(r_eff) * delta**2.5,
        0.0,
    )
    return force, torque, torque_j, xi, pe, in_contact, d


def _pair_elastic_pe(x_i, x_j, q_i, q_j, aux, shapes, params,
                     exact: bool, periodic, tilt, box_lo, box_hi):
    """Sampled elastic PE per pair as a PURE function of (x, q).

    The differentiation target of the conservative force mode: only the
    depth-moment geometry chain, no velocities, no damping/friction.
    """
    s_i, s_j, t_i, t_j, rb_i, rb_j, rm_i, rm_j, rc_i, rc_j, mask = aux
    d = minimum_image(x_j - x_i, box_lo, box_hi, periodic, tilt)
    dist = jnp.linalg.norm(d, axis=-1)
    cull = mask & (dist < rb_i + rb_j) & (dist > 1e-12)
    s1a, s2a, _, _, _ = surface_probe(
        q_i, s_i, t_i, q_j, s_j, t_j, rb_j, rm_i, rb_i, rc_j,
        d, shapes, exact, incl=False
    )
    s1b, s2b, _, _, _ = surface_probe(
        q_j, s_j, t_j, q_i, s_i, t_i, rb_i, rm_j, rb_j, rc_i,
        -d, shapes, exact, incl=False
    )
    s1 = s1a + s1b
    s2 = s2a + s2b
    in_contact = cull & (s1 > 0)
    delta = jnp.where(in_contact, 1.5 * s2 / jnp.maximum(s1, 1e-30), 0.0)
    r_eff = rc_i * rc_j / jnp.maximum(rc_i + rc_j, 1e-12)
    kn_p = state_mod.pair_material(params, t_i, t_j)[..., 0]
    return jnp.where(
        in_contact,
        0.4 * kn_p * jnp.sqrt(r_eff)
        * jnp.maximum(delta, 0.0) ** 2.5,
        0.0,
    )


def pair_elastic_grad(rows_i, rows_j, t_i, t_j, pair_mask,
                      box_lo, box_hi, shapes, params,
                      exact: bool, periodic, tilt):
    """Exact-gradient elastic force/torques: F = -dU/dx, tau = -dU/dth.

    The geometric law assembles depth, normal and application point
    independently, which is measurably non-conservative (one undamped
    Lmax=8 collision loses ~0.35% of the system energy,
    scripts/conservative_probe.py; the NVE drift metric shows the
    secular ~3%/1M-step consequence). Differentiating the SAME sampled
    PE gives forces AND torques consistent with one potential — the
    residual drift is integrator-limited (~dt^2; measured 23x better at
    dt/4).

    Torque from the quaternion cotangent: for a world-frame rotation
    q' = dq (x) q with dq = (1, dtheta/2),
    tau_k = -0.5 * <dU/dq, e_k (x) q>.

    Out-of-contact pairs produce NaN cotangents through dead-branch
    guards (sqrt/div); the true force there is identically zero, so
    non-finite rows are masked to zero.
    """
    x_i, x_j = rows_i[:, _RX], rows_j[:, _RX]
    q_i, q_j = rows_i[:, _RQ], rows_j[:, _RQ]
    aux = (rows_i[:, _RS], rows_j[:, _RS], t_i, t_j,
           rows_i[:, _RRB], rows_j[:, _RRB],
           rows_i[:, _RRM], rows_j[:, _RRM],
           rows_i[:, _RRC], rows_j[:, _RRC], pair_mask)

    def total(xi, xj, qi, qj):
        return jnp.sum(_pair_elastic_pe(
            xi, xj, qi, qj, aux, shapes, params,
            exact, periodic, tilt, box_lo, box_hi,
        ))

    gxi, _, gqi, gqj = jax.grad(total, argnums=(0, 1, 2, 3))(
        x_i, x_j, q_i, q_j
    )

    def tau_of(q, gq):
        taus = []
        for k in range(3):
            e = jnp.zeros((4,), q.dtype).at[k + 1].set(1.0)
            taus.append(-0.5 * jnp.sum(
                gq * rotation.quat_multiply(e[None, :], q), axis=-1
            ))
        return jnp.stack(taus, axis=-1)

    f_el = -gxi  # dU/dx_j = -dU/dx_i exactly (U depends on x_j - x_i)
    tau_el_i = tau_of(q_i, gqi)
    tau_el_j = tau_of(q_j, gqj)
    ok = (
        jnp.isfinite(f_el).all(axis=-1)
        & jnp.isfinite(tau_el_i).all(axis=-1)
        & jnp.isfinite(tau_el_j).all(axis=-1)
    )[..., None]
    return (jnp.where(ok, f_el, 0.0),
            jnp.where(ok, tau_el_i, 0.0),
            jnp.where(ok, tau_el_j, 0.0))


@partial(jax.jit, static_argnames=("exact", "periodic"))
def pair_contact(
    x_i, v_i, q_i, om_i, s_i, t_i, m_i,
    x_j, v_j, q_j, om_j, s_j, t_j, m_j,
    hist, pair_mask, box_lo, box_hi, shapes, params,
    exact: bool = False, periodic=(False, False, False),
):
    """Field-argument wrapper over pair_contact_rows (tests/back-compat)."""
    def pack(x, v, q, om, s, t, m):
        rows = jnp.concatenate([
            x, v, q, om, m[:, None],
            (shapes.rmax[t] * s)[:, None],
            (shapes.rmin[t] * s)[:, None],
            (shapes.rchar[t] * s)[:, None],
            s[:, None],
        ], axis=1).astype(x.dtype)
        return jnp.pad(rows, ((0, 0), (0, ROW_W - rows.shape[1])))

    return pair_contact_rows(
        pack(x_i, v_i, q_i, om_i, s_i, t_i, m_i),
        pack(x_j, v_j, q_j, om_j, s_j, t_j, m_j),
        t_i, t_j, hist, pair_mask, box_lo, box_hi, shapes, params,
        exact=exact, periodic=periodic,
    )


def gather_particle(state, shapes, idx):
    """Gather per-particle fields at indices idx (any shape)."""
    om = rotation.omega_from_angmom(
        state.q[idx], state.angmom[idx],
        shapes.inertia_of(state.shtype[idx], state.scale[idx]),
    )
    m = shapes.mass_of(state.shtype[idx], state.scale[idx])
    return (
        state.x[idx], state.v[idx], state.q[idx], om,
        state.scale[idx], state.shtype[idx], m,
    )


@partial(jax.jit, static_argnames=("exact", "periodic", "chunk",
                                   "conservative"))
def contact_force_dense(state, shapes, params, neigh,
                        exact: bool = False,
                        periodic=(False, False, False),
                        chunk: int = 0, tilt=None,
                        conservative: bool = False):
    """Force/torque over the dense [N, K] neighbor tensor.

    Returns (f [N,3], tau [N,3], new_hist [N,K,3], pe_total, virial [3,3]).
    Full-list semantics: each contact contributes to its row only; pe and
    virial are halved to undo double counting.

    ``chunk``: if > 0, process rows in blocks of this size with lax.map to
    bound [N*K, G] intermediates (device-memory working set).
    """
    N, K = neigh.idx.shape
    i_idx = jnp.broadcast_to(jnp.arange(N)[:, None], (N, K))
    rows = particle_rows(state, shapes)

    def run(block):
        ri, rj, ti, tj, msk, hist = block
        msk = msk & (ri[:, _RACT] > 0.5) & (rj[:, _RACT] > 0.5)
        return pair_contact_rows(
            ri, rj, ti, tj, hist, msk,
            state.box_lo, state.box_hi, shapes, params,
            exact=exact, periodic=periodic, tilt=tilt,
            conservative=conservative,
        )

    flat_i = i_idx.reshape(-1)
    flat_j = neigh.idx.reshape(-1)
    blocks = (rows[flat_i], rows[flat_j],
              state.shtype[flat_i], state.shtype[flat_j],
              neigh.mask.reshape(-1),
              neigh.hist.reshape(-1, neigh.hist.shape[-1]))
    if chunk and N * K > chunk:
        n_chunks = -(-N * K // chunk)
        pad = n_chunks * chunk - N * K
        blocks = jax.tree.map(
            lambda a: jnp.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1)),
            blocks,
        )
        blocks = jax.tree.map(
            lambda a: a.reshape((n_chunks, chunk) + a.shape[1:]), blocks
        )
        force, torque, _, hist_new, pe, inc, d = jax.lax.map(run, blocks)
        unpad = lambda a: a.reshape((n_chunks * chunk,) + a.shape[2:])[: N * K]
        force, torque, hist_new, pe, inc, d = (
            unpad(force), unpad(torque), unpad(hist_new), unpad(pe),
            unpad(inc), unpad(d),
        )
    else:
        force, torque, _, hist_new, pe, inc, d = run(blocks)

    f = jnp.sum(force.reshape(N, K, 3), axis=1)
    tau = jnp.sum(torque.reshape(N, K, 3), axis=1)
    pe_total = 0.5 * jnp.sum(pe)
    # Virial: W_ab = -1/2 sum_pairs d_a F_b (d = x_j - x_i, F on i).
    virial = -0.5 * jnp.einsum("pa,pb->ab", d, force,
                               precision=jax.lax.Precision.HIGHEST)
    return f, tau, hist_new.reshape(N, K, -1), pe_total, virial


@partial(jax.jit, static_argnames=("pair_cap", "periodic", "half"))
def build_pair_list(state, shapes, params, neigh_idx, neigh_mask, hist,
                    owned, pair_cap: int,
                    periodic=(False, False, False), half: bool = True,
                    tilt=None):
    """Compact the [N, K] Verlet tensor into a stable pair list.

    Runs ONCE per neighbor rebuild (LAMMPS's actual structure: the pair
    loop iterates a half list built at reneighbor time). Keeps every
    pair whose bounding spheres can touch before the next rebuild
    (dist < rb_i + rb_j + skin: each particle moves at most skin/2
    between rebuilds, so the relative approach is bounded by skin).

    ``half=True`` keeps each owned-owned pair once (lower slot first;
    the step kernel applies force/torque to both sides) and owned-ghost
    pairs one-sided (the ghost's owner shard evaluates the mirror) —
    halving the narrow-phase FLOPs vs the full list.

    Compaction is cumsum+scatter (no argsort): pair_i stays sorted, so
    the i-side force reduction is a sorted segment-sum. A rebuild-time
    argsort of pair_j gives the j-side reaction the same property.

    Returns (fields: dict of NeighborState pair_* leaves, n_pairs).
    ``n_pairs > pair_cap`` means dropped pairs — fold into overflow.
    """
    N, K = neigh_idx.shape
    hw = hist.shape[-1]
    rb = shapes.rmax[state.shtype] * state.scale
    xj = state.x[neigh_idx]
    d = minimum_image(
        xj - state.x[:, None, :], state.box_lo, state.box_hi, periodic, tilt
    )
    dist2 = jnp.sum(d * d, axis=-1)
    margin = rb[:, None] + rb[neigh_idx] + params.skin
    owned_j = owned[neigh_idx]
    keep = (
        neigh_mask
        & (dist2 < margin * margin)
        & owned[:, None]
        & state.active[neigh_idx]
    )
    if half:
        i_col = jnp.arange(N, dtype=jnp.int32)[:, None]
        keep = keep & (~owned_j | (neigh_idx > i_col))

    flat = keep.reshape(-1)
    n_pairs = jnp.sum(flat.astype(jnp.int32))
    pos = jnp.cumsum(flat.astype(jnp.int32)) - 1
    tgt = jnp.where(flat & (pos < pair_cap), pos, pair_cap)
    pair_sel = (
        jnp.full((pair_cap + 1,), N * K, jnp.int32)
        .at[tgt].set(jnp.arange(N * K, dtype=jnp.int32), mode="drop")[:pair_cap]
    )
    valid = pair_sel < N * K
    sel_safe = jnp.minimum(pair_sel, N * K - 1)
    pi = (sel_safe // K).astype(jnp.int32)
    pj = neigh_idx.reshape(-1)[sel_safe]
    # Invalid slots route to row N-1 with zero force (keeps ids sorted).
    pi = jnp.where(valid, pi, N - 1)
    pj = jnp.where(valid, pj, N - 1)
    pair_both = jnp.where(valid, owned_j.reshape(-1)[sel_safe], False)
    pair_hist = jnp.where(
        valid[:, None], hist.reshape(-1, hw)[sel_safe], 0.0
    )
    # Mirror slot k' with idx[pj, k'] == pi (for the rebuild-time
    # scatter-back of springs into BOTH tag-keyed rows). Ghost rows have
    # no entries (owned-masked at build), so mirrors exist only for
    # owned-owned pairs; a row-overflowed mirror is silently absent
    # (flagged by the K-overflow counter anyway).
    row_j = neigh_idx[pj]
    hit = (row_j == pi[:, None]) & neigh_mask[pj]
    kk = jnp.argmax(hit, axis=1).astype(jnp.int32)
    found = jnp.any(hit, axis=1) & valid & pair_both
    pair_selj = jnp.where(found, pj * K + kk, N * K)
    pair_jsort = jnp.argsort(pj).astype(jnp.int32)
    fields = dict(
        pair_i=pi, pair_j=pj, pair_valid=valid, pair_both=pair_both,
        pair_hist=pair_hist, pair_sel=pair_sel, pair_selj=pair_selj,
        pair_jsort=pair_jsort,
    )
    return fields, n_pairs


def _probe_side_depth(q_a, q_b, t_a, t_b, rb_b, rm_a, rb_a, d, dist,
                      cap1, lmax: int):
    """Max signed node depth (r_b - rho) of a's coarse cap nodes inside
    b, per pair [P]: the r-only half of surface_probe on the power
    basis."""
    cap_x, cap_cpsi, cap_spsi = cap1
    e_body = quat_rotate_inv(q_a, d / dist[:, None])
    rho_star = jnp.sqrt(jnp.maximum(dist * dist - rb_b * rb_b, 0.0))
    rho_c = jnp.clip(rho_star, rm_a, rb_a)
    cos_gmax = jnp.clip(
        (rho_c * rho_c + dist * dist - rb_b * rb_b)
        / jnp.maximum(2.0 * rho_c * dist, 1e-12),
        -1.0, 1.0 - 1e-6,
    )
    cos_g = 1.0 - (1.0 - cos_gmax)[:, None] * cap_x[None, :]
    sin_g = jnp.sqrt(jnp.maximum(1.0 - cos_g * cos_g, 0.0))
    t1, t2 = _orthobasis(e_body)
    dirs = (
        cos_g[..., None] * e_body[:, None, :]
        + (sin_g * cap_cpsi)[..., None] * t1[:, None, :]
        + (sin_g * cap_spsi)[..., None] * t2[:, None, :]
    )
    r_a = sh_power.eval_power_radius(t_a, *_unit_trig(dirs), lmax, xp=jnp)
    rel = quat_rotate(q_a[:, None, :], r_a[..., None] * dirs)
    u = quat_rotate_inv(q_b[:, None, :], rel - d[:, None, :])
    rho = jnp.sqrt(jnp.maximum(jnp.sum(u * u, axis=-1), 1e-24))
    r_b = sh_power.eval_power_radius(
        t_b, *_unit_trig(u / rho[..., None]), lmax, xp=jnp)
    return jnp.max(r_b - rho, axis=-1)


def probe_depth(rows_i, rows_j, tab_i, tab_j, d, mask, cap1, lmax: int):
    """Rebuild-time r-only containment probe on the coarse cap grid.

    rows_*: particle_rows of each side; tab_*: per-pair pre-scaled A/B
    power-table rows [P, (lmax+1)^2]; d: minimum-image x_j - x_i; cap1:
    (x, cos psi, sin psi) of the coarse grid. Returns, per pair, the
    larger of both directions' max node depth (> 0: a node of one
    surface lies inside the other). Bounding-sphere-separated pairs are
    not probed (the cap geometry assumes dist < rsum) but still report
    a valid upper bound, rsum - dist: surfaces sit inside the spheres,
    so this keeps rebuild-cadence prefiltering sound for pairs that
    close into sphere contact within the window. Masked pairs get -1e9.
    """
    dist = jnp.sqrt(jnp.maximum(jnp.sum(d * d, axis=-1), 1e-24))
    q_i, q_j = rows_i[:, _RQ], rows_j[:, _RQ]
    rb_i, rb_j = rows_i[:, _RRB], rows_j[:, _RRB]
    rm_i, rm_j = rows_i[:, _RRM], rows_j[:, _RRM]
    m_ij = _probe_side_depth(q_i, q_j, tab_i, tab_j, rb_j, rm_i, rb_i, d,
                             dist, cap1, lmax)
    m_ji = _probe_side_depth(q_j, q_i, tab_j, tab_i, rb_i, rm_j, rb_j, -d,
                             dist, cap1, lmax)
    rsum = rb_i + rb_j
    depth = jnp.where(dist < rsum, jnp.maximum(m_ij, m_ji), rsum - dist)
    return jnp.where(mask & (dist > 1e-12), depth, -1e9)


# Coarse-grid slack of the prefilter probe, in units of the pair's
# smaller scaled rchar: the probe (32 cap nodes) plus this slack bounds
# the fine-grid node depth of every pair in contact.
PROBE_SLACK = 0.08


def probe_pairs(state, shapes, pi, pj, mask, d, rows):
    """probe_depth of index pairs (pi, pj) with minimum-image d = x_j -
    x_i, on the coarse cap grid with full-basis A/B power tables."""
    # r-only A/B prefix of the power tables (ops/sh_power.py), full
    # basis: a truncation tail bound would eat the filter margin.
    tab = shapes.power_tbl[:, :(shapes.lmax + 1) ** 2]
    cap1 = (shapes.cap1_x, shapes.cap1_cpsi, shapes.cap1_spsi)
    return probe_depth(
        rows[pi], rows[pj],
        tab[state.shtype[pi]] * state.scale[pi][:, None],
        tab[state.shtype[pj]] * state.scale[pj][:, None],
        d, mask, cap1, shapes.lmax,
    )


def max_node_depth(rows_i, rows_j, t_i, t_j, d, shapes, exact=True):
    """Largest node depth of either surface inside the other on the fine
    contact cap grid, per pair [P]: what probe_pairs + PROBE_SLACK * rc
    must bound for every pair in contact."""
    args_i = (rows_i[:, _RQ], rows_i[:, _RS])
    args_j = (rows_j[:, _RQ], rows_j[:, _RS])
    *_, dep1 = surface_probe(*args_i, t_i, *args_j, t_j, rows_j[:, _RRB],
                             rows_i[:, _RRM], rows_i[:, _RRB],
                             rows_j[:, _RRC], d, shapes, exact)
    *_, dep2 = surface_probe(*args_j, t_j, *args_i, t_i, rows_i[:, _RRB],
                             rows_j[:, _RRM], rows_j[:, _RRB],
                             rows_i[:, _RRC], -d, shapes, exact)
    return jnp.maximum(dep1, dep2)


@partial(jax.jit, static_argnames=("keep_cap", "k_max", "window_steps",
                                   "floor_frac", "periodic", "probe_chunk",
                                   "axes"))
def prefilter_pair_list(state, shapes, params, fields, keep_cap: int,
                        k_max: int, window_steps: int = 16,
                        floor_frac: float = 0.25,
                        periodic=(False, False, False), tilt=None,
                        probe_chunk: int = 262144, axes=None):
    """Rebuild-time narrow-phase prefilter: compact the bounding-sphere
    candidate pair list down to pairs that can actually touch before the
    next rebuild (the contact analogue of the Verlet skin).

    Runs a FULL-basis f32 r-only containment probe ONCE per rebuild over
    the candidate list (exactness is affordable at rebuild cadence; the
    l1-truncation tail bound ~0.3 r for rough lmax=8 blobs would eat the
    whole filter margin) and keeps pairs with probe depth above
    ``-(0.08 * min(rc_i, rc_j) + b_i + b_j)`` (scaled per-pair rchar)
    where b_i is the particle's
    MOTION BUDGET for the window:

      b_i = clip(T (|v_i| + gmax_i |omega_i|) + slack,
                 floor_frac * skin, skin / 2),
      slack = T^2 (amax + gmax_i * alpmax)        (velocity growth),
      T = window_steps * dt,
      amax / alpmax = current max |f|/m + |g|, max |tau|/I.

    The rebuild trigger (ops.neighbor.approach_ratio) fires when ANY
    particle's |dx| + gmax * alpha exceeds ITS recorded b_i, so a pair's
    surfaces close by at most b_i + b_j between rebuilds — resting
    particles get tight budgets (small pair list), fast ones get
    headroom (no rebuild storm); the skin/2 cap keeps the candidate
    list's own Verlet guarantee intact. 0.08 rchar is the probe's
    coarse-grid slack (unchanged from the per-step two-stage design).
    Box deformation is assumed slow on the skin scale per window — the
    same assumption the Verlet skin already makes.

    The per-step force kernel then runs the FULL evaluation over this
    compacted list with no per-step probe, pack-of-candidates, or
    survivor gather. Returns (fields2 sized keep_cap, n_survivors,
    budget [N]); n_survivors > keep_cap means dropped contacts —
    overflow channel.
    """
    pi, pj = fields["pair_i"], fields["pair_j"]
    P = pi.shape[0]
    rows = particle_rows(state, shapes)
    msk = (
        fields["pair_valid"]
        & (rows[pi, _RACT] > 0.5)
        & (rows[pj, _RACT] > 0.5)
    )
    dp = minimum_image(
        rows[pj][:, _RX] - rows[pi][:, _RX],
        state.box_lo, state.box_hi, periodic, tilt,
    )
    # Probe on the COARSE cap grid (Shapes.cap1_*, 32 nodes) — the
    # PROBE_SLACK margin below is calibrated for exactly this grid.
    def probe_rows(args):
        pi_b, pj_b, msk_b, dp_b = args
        return probe_pairs(state, shapes, pi_b, pj_b, msk_b, dp_b, rows)

    if probe_chunk and P > probe_chunk:
        C = probe_chunk
        nb = -(-P // C)
        pad = nb * C - P
        padp = lambda a: jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))
        depth = jax.lax.map(probe_rows, (
            padp(pi).reshape(nb, C), padp(pj).reshape(nb, C),
            padp(msk).reshape(nb, C), padp(dp).reshape(nb, C, 3),
        )).reshape(nb * C)[:P]
    else:
        depth = probe_rows((pi, pj, msk, dp))

    # Per-particle motion budgets (see docstring).
    T = window_steps * params.dt
    act = rows[:, _RACT] > 0.5
    gmax_s = shapes.gmax[state.shtype] * state.scale
    m = jnp.maximum(rows[:, _RM_], 1e-30)
    speed = jnp.linalg.norm(rows[:, _RV], axis=-1)
    omag = jnp.linalg.norm(rows[:, _ROM], axis=-1)
    amax = jnp.max(jnp.where(
        act, jnp.linalg.norm(state.f, axis=-1) / m, 0.0
    )) + jnp.linalg.norm(params.gravity)
    inert = shapes.inertia_of(state.shtype, state.scale)
    alpmax = jnp.max(jnp.where(
        act,
        jnp.linalg.norm(state.tau, axis=-1)
        / jnp.maximum(jnp.min(inert, axis=-1), 1e-30),
        0.0,
    ))
    if axes is not None:
        # Sharded: the slack maxima must be GLOBAL. A shard-local amax
        # would give a ghost row a smaller budget than its owner
        # recorded, so the owner's approach_ratio trigger could not
        # protect the ghost-side pair survival margin (v/omega per
        # particle are identical across copies via forward comm; only
        # these two maxima differ).
        amax = jax.lax.pmax(amax, axes)
        alpmax = jax.lax.pmax(alpmax, axes)
    budget = jnp.clip(
        T * (speed + gmax_s * omag) + T * T * (amax + gmax_s * alpmax),
        floor_frac * params.skin,
        0.5 * params.skin,
    )
    budget = jnp.where(act, budget, 0.0)

    # Coarse-grid slack scales with the PAIR's smaller particle (scaled
    # rchar): the probe's node-spacing error grows with particle size,
    # and a wrongly culled grazing pair stays dropped for the whole
    # rebuild window — the global unit-scale minimum under-protects
    # scaled-up or large-type pairs.
    rc_pair = jnp.minimum(rows[pi, _RRC], rows[pj, _RRC])
    margin = PROBE_SLACK * rc_pair + budget[pi] + budget[pj]
    survive = msk & (depth > -margin)

    n_surv = jnp.sum(survive.astype(jnp.int32))
    pos = jnp.cumsum(survive.astype(jnp.int32)) - 1
    tgt = jnp.where(survive & (pos < keep_cap), pos, keep_cap)
    sel = (
        jnp.full((keep_cap + 1,), P, jnp.int32)
        .at[tgt].set(jnp.arange(P, dtype=jnp.int32), mode="drop")
    )[:keep_cap]
    ok = sel < P
    sels = jnp.minimum(sel, P - 1)
    N = state.cap
    none = jnp.int32(N * k_max)  # build_pair_list's "no dense slot"
    # Compaction preserves pair_i's ascending order (sel is increasing;
    # the invalid tail routes to N-1 >= every slot), so the i-side
    # segment-sum stays a sorted reduction.
    pair_i = jnp.where(ok, pi[sels], N - 1)
    pair_j = jnp.where(ok, pj[sels], N - 1)
    fields2 = dict(
        pair_i=pair_i,
        pair_j=pair_j,
        pair_valid=fields["pair_valid"][sels] & ok,
        pair_both=fields["pair_both"][sels] & ok,
        pair_hist=jnp.where(ok[:, None], fields["pair_hist"][sels], 0.0),
        pair_sel=jnp.where(ok, fields["pair_sel"][sels], none),
        pair_selj=jnp.where(ok, fields["pair_selj"][sels], none),
        pair_jsort=jnp.argsort(pair_j).astype(jnp.int32),
    )
    return fields2, n_surv, budget


def pair_hist_to_dense(neigh):
    """Scatter live pair springs back into the tag-keyed [N, K] layout.

    Called at rebuild time, BEFORE migration/remap: both the (i->j) slot
    and the mirror (j->i) slot are written, so remap_history finds the
    spring regardless of which direction the next half-list pick or a
    shard migration lands on. The mirror's TANGENTIAL part is negated
    (row j's spring accumulates -v_t of row i's); the ROLLING part is
    direction-symmetric (v_roll(j,i) == v_roll(i,j)).
    """
    N, K, hw = neigh.hist.shape
    val = jnp.where(neigh.pair_valid[:, None], neigh.pair_hist, 0.0)
    mirror_sign = jnp.asarray(
        [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0][:hw], neigh.hist.dtype
    )
    flat = jnp.zeros((N * K + 1, hw), neigh.hist.dtype)
    flat = flat.at[neigh.pair_sel].set(val, mode="drop")
    flat = flat.at[neigh.pair_selj].set(val * mirror_sign, mode="drop")
    return flat[:-1].reshape(N, K, hw)


@partial(jax.jit, static_argnames=("exact", "periodic", "chunk",
                                   "conservative"))
def contact_force_pairs(state, shapes, params, neigh,
                        exact: bool = True,
                        periodic=(False, False, False),
                        chunk: int = 16384,
                        tilt=None,
                        conservative: bool = False):
    """Per-step force/torque over the stable pair list (the hot path).

    No per-step broad phase, probe, sort, or [N, K] traffic: two
    row-gathers, the narrow-phase kernel, two sorted segment-sums per
    output. Springs update in place in pair space. With the rebuild-time
    prefilter (prefilter_pair_list) the list already holds only
    near-contact pairs, so the full kernel runs over every slot.

    Returns (f [N,3], tau [N,3], pair_hist [Pc,HW], pe_total, virial).
    """
    N = state.cap
    pi, pj = neigh.pair_i, neigh.pair_j
    rows = particle_rows(state, shapes)
    rows_i = rows[pi]
    rows_j = rows[pj]
    msk = (
        neigh.pair_valid
        & (rows_i[:, _RACT] > 0.5)
        & (rows_j[:, _RACT] > 0.5)
    )
    P = pi.shape[0]

    def run(block):
        ri, rj, ti, tj, m, h = block
        return pair_contact_rows(
            ri, rj, ti, tj, h, m,
            state.box_lo, state.box_hi, shapes, params,
            exact=exact, periodic=periodic, tilt=tilt,
            conservative=conservative,
        )

    blocks = (rows_i, rows_j, state.shtype[pi], state.shtype[pj],
              msk, neigh.pair_hist)
    if chunk and P > chunk:
        n_chunks = -(-P // chunk)
        pad = n_chunks * chunk - P
        blocks = jax.tree.map(
            lambda a: jnp.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1)),
            blocks,
        )
        blocks = jax.tree.map(
            lambda a: a.reshape((n_chunks, chunk) + a.shape[1:]), blocks
        )
        outs = jax.lax.map(run, blocks)
        unpad = lambda a: a.reshape(
            (n_chunks * chunk,) + a.shape[2:]
        )[:P]
        force, torque, torque_j, hist_new, pe, _, d = (
            jax.tree.map(unpad, outs)
        )
    else:
        force, torque, torque_j, hist_new, pe, _, d = run(blocks)

    # i side: pair_i is sorted by construction. Force and torque ride
    # one [P, 6] segment-sum (one pass over the pair index per side —
    # these scatters are HBM-bandwidth ops at pair-list scale).
    acc_i = jax.ops.segment_sum(
        jnp.concatenate([force, torque], axis=1), pi, num_segments=N,
        indices_are_sorted=True,
    )
    # j side (reaction; only half-list owned-owned pairs): permute into
    # pair_j-sorted order so this is a sorted segment-sum too.
    w_j = (msk & neigh.pair_both).astype(force.dtype)[:, None]
    perm = neigh.pair_jsort
    acc_j = jax.ops.segment_sum(
        jnp.concatenate([-force * w_j, torque_j * w_j], axis=1)[perm],
        pj[perm], num_segments=N, indices_are_sorted=True,
    )
    f = acc_i[:, 0:3] + acc_j[:, 0:3]
    tau = acc_i[:, 3:6] + acc_j[:, 3:6]
    # Each half-list pair counted once; one-sided (ghost) pairs are
    # evaluated once per owning shard, so weight 1/2 keeps global sums
    # exact after psum.
    w_pe = jnp.where(msk & neigh.pair_both, 1.0, 0.5)
    pe_total = jnp.sum(pe * w_pe)
    virial = -jnp.einsum("p,pa,pb->ab", w_pe, d, force,
                         precision=jax.lax.Precision.HIGHEST)
    return f, tau, hist_new, pe_total, virial
