"""Quaternion rigid-body velocity-Verlet integration.

Array-program equivalent of the reference's SH NVE integrator
(SURVEY.md section 2 B.5, expected ``src/SPHERHARM/fix_nve_sh.cpp``;
contract BASELINE.json:5 "quaternion rigid-body velocity-Verlet
integration"). The scheme mirrors upstream LAMMPS ``fix nve/asphere``:

  initial_integrate (half kick + drift):
    v      += dt/2 * f / m
    x      += dt * v
    L      += dt/2 * tau            (world-frame angular momentum)
    q      <- richardson(q, L, I_body, dt)   (2nd-order quaternion update)
  final_integrate (second half kick, after new forces):
    v      += dt/2 * f / m
    L      += dt/2 * tau

Richardson extrapolation: combine one full-dt and two half-dt quaternion
Euler updates, q <- normalize(2*q_half - q_full), re-deriving omega from
the (constant over the half step) angular momentum at the midpoint —
the standard LAMMPS scheme for torque-accurate rigid-body rotation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from spherharm_tpu.ops.rotation import (
    omega_from_angmom,
    quat_derivative,
    quat_normalize,
)


def _euler_quat(q, angmom, inertia_body, dt):
    omega = omega_from_angmom(q, angmom, inertia_body)
    return quat_normalize(q + dt * quat_derivative(q, omega))


def richardson_quat_update(q, angmom, inertia_body, dt):
    """Second-order quaternion rotation update at fixed angular momentum."""
    q_full = _euler_quat(q, angmom, inertia_body, dt)
    q_half = _euler_quat(q, angmom, inertia_body, 0.5 * dt)
    q_half = _euler_quat(q_half, angmom, inertia_body, 0.5 * dt)
    return quat_normalize(2.0 * q_half - q_full)


def initial_integrate(state, shapes, params):
    """Half-kick velocities/angmom, drift positions, rotate quaternions."""
    m = shapes.mass_of(state.shtype, state.scale)[:, None]
    inertia = shapes.inertia_of(state.shtype, state.scale)
    act = state.active[:, None]
    dt = params.dt
    v = jnp.where(act, state.v + 0.5 * dt * state.f / m, state.v)
    x = jnp.where(act, state.x + dt * v, state.x)
    angmom = jnp.where(act, state.angmom + 0.5 * dt * state.tau, state.angmom)
    q = jnp.where(
        act, richardson_quat_update(state.q, angmom, inertia, dt), state.q
    )
    return state.replace(x=x, v=v, q=q, angmom=angmom,
                         step=state.step + 1)


def final_integrate(state, shapes, params):
    """Second half-kick from freshly computed forces/torques."""
    m = shapes.mass_of(state.shtype, state.scale)[:, None]
    act = state.active[:, None]
    dt = params.dt
    v = jnp.where(act, state.v + 0.5 * dt * state.f / m, state.v)
    angmom = jnp.where(act, state.angmom + 0.5 * dt * state.tau, state.angmom)
    return state.replace(v=v, angmom=angmom)


def apply_deformation(state, x_build, params, periodic=(False, False, False)):
    """Affine box deformation about the box center (fix deform analogue).

    Diagonal strain-rate control for the triaxial shear cell (config 5,
    BASELINE.json:11): box edges and ALL positions (including the
    neighbor-build reference positions, so no spurious skin triggers)
    are remapped by (1 + rate*dt) each step. Off-diagonal ``shear_rate``
    (d vx/dy, d vx/dz, d vy/dz) applies the matching affine velocity
    gradient and grows the triclinic tilt (fix deform xy/xz/yz with
    remap). Zero rates are an exact no-op.

    Sustained shear flips the tilt back into the LAMMPS bound
    |xy|,|xz| <= Lx/2 and |yz| <= Ly/2 (subtracting a whole box edge
    vector — an exact relabeling of the periodic lattice) whenever the
    shifted axis is periodic; minimum_image's sequential image removal
    is only valid inside that bound. For non-periodic shift axes the
    flip is not a lattice symmetry; callers flag |tilt| > L/2 through
    the overflow channel instead (see Simulation._step_core).

    Returns (state, x_build, flip): ``flip`` [3] is the whole-edge
    multiple removed from each tilt component (zeros when no flip).
    """
    factor = 1.0 + params.deform_rate * params.dt  # [3]
    center = 0.5 * (state.box_lo + state.box_hi)
    x = center + (state.x - center) * factor
    xb = center + (x_build - center) * factor
    box_lo = center + (state.box_lo - center) * factor
    box_hi = center + (state.box_hi - center) * factor

    g = params.shear_rate * params.dt  # (d_xy, d_xz, d_yz) increments
    L = box_hi - box_lo

    def shear(p):
        sx = p[..., 0] + g[0] * (p[..., 1] - center[1]) \
            + g[1] * (p[..., 2] - center[2])
        sy = p[..., 1] + g[2] * (p[..., 2] - center[2])
        return jnp.stack([sx, sy, p[..., 2]], axis=-1)

    x = shear(x)
    xb = shear(xb)
    # Tilt components are x-offsets (xy, xz) / a y-offset (yz): they
    # scale with the matching diagonal factor, then grow with the shear.
    # Shearing the cell vectors b=(xy,Ly,0), c=(xz,yz,Lz) by the same
    # affine map as positions: xz picks up the g_xy * yz cross-term.
    t = state.tilt * jnp.stack([factor[0], factor[0], factor[1]])
    xy = t[0] + g[0] * L[1]
    xz = t[1] + g[0] * t[2] + g[1] * L[2]
    yz = t[2] + g[2] * L[2]
    # LAMMPS tilt flip. yz flips by the b vector (needs periodic y) and
    # drags xz along by -xy per flip (c' = c - b); xy/xz flip by the a
    # vector (needs periodic x). Positions need no remap: wrap_positions
    # re-wraps by whole lattice vectors of the CURRENT cell.
    can_x = jnp.asarray(float(periodic[0]), t.dtype)
    can_y = jnp.asarray(float(periodic[1]), t.dtype)
    f_yz = jnp.round(yz / L[1]) * can_y
    yz = yz - f_yz * L[1]
    xz = xz - f_yz * xy
    f_xy = jnp.round(xy / L[0]) * can_x
    f_xz = jnp.round(xz / L[0]) * can_x
    xy = xy - f_xy * L[0]
    xz = xz - f_xz * L[0]
    tilt = jnp.stack([xy, xz, yz])
    flip = jnp.stack([f_xy, f_xz, f_yz])
    state = state.replace(
        x=x, box_lo=box_lo, box_hi=box_hi, tilt=tilt,
    )
    return state, xb, flip


def berendsen_box_control(state, x_build, params, virial, shapes):
    """Anisotropic Berendsen stress servo (fix press/berendsen analogue).

    Per-axis dilation mu_a = 1 - dt/(3 tau) * (P_target_a - P_a), clipped
    to +-1% per step, applied to box and positions (SURVEY.md 2 B.5
    "box deform & stress control for the triaxial shear cell").
    Disabled when press_tau == 0 (exact no-op).
    """
    m = shapes.mass_of(state.shtype, state.scale)
    kin = jnp.einsum(
        "n,na,na->a", jnp.where(state.active, m, 0.0), state.v, state.v,
        precision=jax.lax.Precision.HIGHEST,
    )
    vol = jnp.prod(state.box_hi - state.box_lo)
    p_diag = (kin + jnp.diagonal(virial)) / vol
    inv_tau = jnp.where(
        params.press_tau > 0, 1.0 / jnp.maximum(params.press_tau, 1e-30), 0.0
    )
    mu = 1.0 - (params.dt * inv_tau / 3.0) * (params.press_target - p_diag)
    mu = jnp.clip(mu, 0.99, 1.01)
    center = 0.5 * (state.box_lo + state.box_hi)
    state = state.replace(
        x=center + (state.x - center) * mu,
        box_lo=center + (state.box_lo - center) * mu,
        box_hi=center + (state.box_hi - center) * mu,
        tilt=state.tilt * jnp.stack([mu[0], mu[0], mu[1]]),
    )
    return state, center + (x_build - center) * mu


def kinetic_energy(state, shapes):
    """Translational + rotational KE (masked)."""
    m = shapes.mass_of(state.shtype, state.scale)
    inertia = shapes.inertia_of(state.shtype, state.scale)
    ke_t = 0.5 * jnp.sum(
        jnp.where(state.active, m * jnp.sum(state.v**2, axis=-1), 0.0)
    )
    omega = omega_from_angmom(state.q, state.angmom, inertia)
    ke_r = 0.5 * jnp.sum(
        jnp.where(state.active, jnp.sum(omega * state.angmom, axis=-1), 0.0)
    )
    return ke_t, ke_r
