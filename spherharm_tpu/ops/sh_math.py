"""Real spherical-harmonic math for SH-DEM particle surfaces.

Array-program replacement for the reference fork's SH math helper
(SURVEY.md section 2 B.4, expected at ``src/SPHERHARM/math_spherharm.cpp``
in the reference once code lands; capability contract: BASELINE.json:5
"associated-Legendre/Ylm recurrences, radius evaluation on Gauss-Legendre
quadrature grids").

Conventions
-----------
Surfaces are star-convex radius fields ``r(theta, phi) = sum_nm a_nm Y_nm``
with *real*, *fully normalized* spherical harmonics and **no**
Condon-Shortley phase:

    Y_n0      = Pbar_n0(cos theta)
    Y_nm, m>0 = sqrt(2) * Pbar_nm(cos theta) * cos(m phi)
    Y_nm, m<0 = sqrt(2) * Pbar_n|m|(cos theta) * sin(|m| phi)

where ``Pbar_nm`` is the fully-normalized associated Legendre function,
``integral |Y_nm|^2 dOmega = 1``. A sphere of radius R is then the single
coefficient ``a_00 = R * sqrt(4 pi)``.

Coefficient layout: flat index ``n*n + (m + n)`` for n in [0, lmax],
m in [-n, n]; a coefficient vector has ``(lmax+1)**2`` entries.

All evaluators take a *static* ``lmax`` and unroll the recurrences in
Python so XLA sees straight-line vector code (no dynamic shapes; SURVEY.md
section 7.1).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from scipy.special import roots_legendre


def n_coeffs(lmax: int) -> int:
    """Number of real SH coefficients for a given lmax."""
    return (lmax + 1) ** 2


def sh_index(n: int, m: int) -> int:
    """Flat index of the (n, m) real SH coefficient."""
    return n * n + (m + n)


# ---------------------------------------------------------------------------
# Associated Legendre (fully normalized, no Condon-Shortley phase)
# ---------------------------------------------------------------------------


def _alp_all(cos_t, sin_t, lmax: int):
    """All fully-normalized ALPs ``Pbar_nm`` for n<=lmax, 0<=m<=n.

    Stable column-wise recurrence (Holmes & Featherstone 2002 style):

      Pbar_00      = 1/sqrt(4 pi)
      Pbar_mm      = sqrt((2m+1)/(2m))            * sin(t) * Pbar_{m-1,m-1}
      Pbar_{m+1,m} = sqrt(2m+3)                   * cos(t) * Pbar_mm
      Pbar_nm      = a_nm cos(t) Pbar_{n-1,m} - b_nm Pbar_{n-2,m}
        a_nm = sqrt((4n^2-1)/(n^2-m^2))
        b_nm = sqrt(((2n+1)/(2n-3)) * ((n-1)^2-m^2)/(n^2-m^2))

    Returns a dict {(n, m): array} of arrays shaped like ``cos_t``.
    """
    P = {}
    P[(0, 0)] = jnp.full_like(cos_t, 1.0 / math.sqrt(4.0 * math.pi))
    for m in range(1, lmax + 1):
        P[(m, m)] = math.sqrt((2 * m + 1) / (2 * m)) * sin_t * P[(m - 1, m - 1)]
    for m in range(0, lmax):
        P[(m + 1, m)] = math.sqrt(2 * m + 3) * cos_t * P[(m, m)]
    for m in range(0, lmax + 1):
        for n in range(m + 2, lmax + 1):
            a = math.sqrt((4 * n * n - 1) / (n * n - m * m))
            b = math.sqrt(
                ((2 * n + 1) / (2 * n - 3))
                * ((n - 1) ** 2 - m * m)
                / (n * n - m * m)
            )
            P[(n, m)] = a * cos_t * P[(n - 1, m)] - b * P[(n - 2, m)]
    return P


@partial(jax.jit, static_argnames=("lmax",))
def real_sh_basis(theta, phi, lmax: int):
    """Real SH basis values ``Y[..., (lmax+1)**2]`` at (theta, phi)."""
    cos_t = jnp.cos(theta)
    sin_t = jnp.sin(theta)
    P = _alp_all(cos_t, sin_t, lmax)
    sq2 = math.sqrt(2.0)
    cols = []
    # cos(m phi), sin(m phi) by chained angle addition (cheap, stable).
    cos_m = [jnp.ones_like(phi)]
    sin_m = [jnp.zeros_like(phi)]
    c1, s1 = jnp.cos(phi), jnp.sin(phi)
    for m in range(1, lmax + 1):
        cos_m.append(cos_m[-1] * c1 - sin_m[-1] * s1)
        sin_m.append(sin_m[-1] * c1 + cos_m[-2] * s1)
    for n in range(lmax + 1):
        for m in range(-n, n + 1):
            am = abs(m)
            if m == 0:
                cols.append(P[(n, 0)])
            elif m > 0:
                cols.append(sq2 * P[(n, am)] * cos_m[am])
            else:
                cols.append(sq2 * P[(n, am)] * sin_m[am])
    return jnp.stack(cols, axis=-1)


@partial(jax.jit, static_argnames=("lmax",))
def real_sh_basis_grad(theta, phi, lmax: int):
    """Basis values plus angular derivatives.

    Returns ``(Y, dY_dtheta, dY_dphi)``, each ``[..., (lmax+1)**2]``.

    Uses the normalized-ALP derivative identity
      sin(t) dPbar_nm/dt = n cos(t) Pbar_nm - e_nm Pbar_{n-1,m},
      e_nm = sqrt((n^2 - m^2) (2n+1)/(2n-1))
    with a pole guard on 1/sin(t). Quadrature nodes and radius-table nodes
    are interior points, so the guard never activates in practice.
    """
    cos_t = jnp.cos(theta)
    sin_t = jnp.sin(theta)
    inv_sin = 1.0 / jnp.maximum(jnp.abs(sin_t), 1e-6) * jnp.sign(sin_t + 1e-30)
    P = _alp_all(cos_t, sin_t, lmax)

    dP = {}
    for n in range(lmax + 1):
        for m in range(0, n + 1):
            if n == 0:
                dP[(n, m)] = jnp.zeros_like(cos_t)
                continue
            term = n * cos_t * P[(n, m)]
            if m <= n - 1:
                e = math.sqrt((n * n - m * m) * (2 * n + 1) / (2 * n - 1))
                term = term - e * P[(n - 1, m)]
            dP[(n, m)] = term * inv_sin

    cos_m = [jnp.ones_like(phi)]
    sin_m = [jnp.zeros_like(phi)]
    c1, s1 = jnp.cos(phi), jnp.sin(phi)
    for m in range(1, lmax + 1):
        cos_m.append(cos_m[-1] * c1 - sin_m[-1] * s1)
        sin_m.append(sin_m[-1] * c1 + cos_m[-2] * s1)

    sq2 = math.sqrt(2.0)
    Y, dYt, dYp = [], [], []
    for n in range(lmax + 1):
        for m in range(-n, n + 1):
            am = abs(m)
            if m == 0:
                Y.append(P[(n, 0)])
                dYt.append(dP[(n, 0)])
                dYp.append(jnp.zeros_like(phi))
            elif m > 0:
                Y.append(sq2 * P[(n, am)] * cos_m[am])
                dYt.append(sq2 * dP[(n, am)] * cos_m[am])
                dYp.append(-sq2 * am * P[(n, am)] * sin_m[am])
            else:
                Y.append(sq2 * P[(n, am)] * sin_m[am])
                dYt.append(sq2 * dP[(n, am)] * sin_m[am])
                dYp.append(sq2 * am * P[(n, am)] * cos_m[am])
    return (
        jnp.stack(Y, axis=-1),
        jnp.stack(dYt, axis=-1),
        jnp.stack(dYp, axis=-1),
    )


@partial(jax.jit, static_argnames=("lmax",))
def radius_grad_streaming(coeffs, theta, phi, lmax: int):
    """Radius + angular gradients with immediate coefficient contraction.

    Angle-API wrapper over ``radius_grad_streaming_trig`` (tests and
    generic callers); the hot loop feeds trig components directly.
    """
    return radius_grad_streaming_trig(
        coeffs, jnp.cos(theta), jnp.sin(theta), jnp.cos(phi), jnp.sin(phi),
        lmax,
    )


@partial(jax.jit, static_argnames=("lmax",))
def radius_grad_streaming_trig(coeffs, cos_t, sin_t, cos_p, sin_p, lmax: int):
    """Radius + angular gradients with immediate coefficient contraction.

    Equivalent to contracting ``real_sh_basis_grad`` against per-element
    coefficients, but each (n, m) term is multiplied into the running
    (r, dr/dt, dr/dp) sums as it is produced — no [..., NC] basis tensor
    is ever materialized. Takes TRIG COMPONENTS directly: the hot loop
    derives (cos t, sin t, cos p, sin p) from unit direction vectors
    without ever forming the angles (no arccos/arctan2).

    coeffs: [..., NC] broadcastable against cos_t[...]'s leading dims
    (typically coeffs [P, NC] with cos_t [P, G] -> per-pair coefficient
    columns broadcast along G).
    Returns (r, dr_dt, dr_dp) shaped like cos_t.
    """
    inv_sin = 1.0 / jnp.maximum(jnp.abs(sin_t), 1e-6) * jnp.sign(sin_t + 1e-30)
    sq2 = math.sqrt(2.0)

    def coef(n, m):
        c = coeffs[..., sh_index(n, m)]
        return c[..., None] if coeffs.ndim == cos_t.ndim else c

    r = jnp.zeros_like(cos_t)
    drt = jnp.zeros_like(cos_t)
    drp = jnp.zeros_like(cos_t)

    c1, s1 = cos_p, sin_p
    cos_m_prev = jnp.ones_like(cos_t)
    sin_m_prev = jnp.zeros_like(cos_t)

    # March over m (diagonal-first): for each m, walk n = m .. lmax with
    # the three-term recurrence, touching only two P-columns at a time.
    P_mm = jnp.full_like(cos_t, 1.0 / math.sqrt(4.0 * math.pi))
    for m in range(0, lmax + 1):
        if m > 0:
            P_mm = math.sqrt((2 * m + 1) / (2 * m)) * sin_t * P_mm
            cos_m, sin_m = (
                cos_m_prev * c1 - sin_m_prev * s1,
                sin_m_prev * c1 + cos_m_prev * s1,
            )
            cos_m_prev, sin_m_prev = cos_m, sin_m
        else:
            cos_m, sin_m = cos_m_prev, sin_m_prev

        P_nm1 = None  # P_{n-1, m}
        P_nm = P_mm
        for n in range(m, lmax + 1):
            if n > m:
                if n == m + 1:
                    P_new = math.sqrt(2 * m + 3) * cos_t * P_nm
                else:
                    a = math.sqrt((4 * n * n - 1) / (n * n - m * m))
                    b = math.sqrt(
                        ((2 * n + 1) / (2 * n - 3))
                        * ((n - 1) ** 2 - m * m)
                        / (n * n - m * m)
                    )
                    P_new = a * cos_t * P_nm - b * P_nm1
                P_nm1, P_nm = P_nm, P_new
            # dP via the lower-degree identity.
            if n == 0:
                dP = jnp.zeros_like(cos_t)
            else:
                term = n * cos_t * P_nm
                if n - 1 >= m:
                    e = math.sqrt((n * n - m * m) * (2 * n + 1) / (2 * n - 1))
                    term = term - e * P_nm1
                dP = term * inv_sin
            if m == 0:
                a0 = coef(n, 0)
                r = r + a0 * P_nm
                drt = drt + a0 * dP
            else:
                ac = sq2 * coef(n, m)
                as_ = sq2 * coef(n, -m)
                yc = P_nm * cos_m
                ys = P_nm * sin_m
                r = r + ac * yc + as_ * ys
                drt = drt + (ac * cos_m + as_ * sin_m) * dP
                drp = drp + m * (as_ * yc - ac * ys)
    return r, drt, drp


def radius_from_basis(coeffs, basis):
    """Contract coefficients against a basis: ``r = sum_c a_c Y_c``.

    coeffs: [..., NC], basis: [..., NC] (broadcastable) -> [...].
    """
    return jnp.sum(coeffs * basis, axis=-1)


# ---------------------------------------------------------------------------
# Quadrature on the sphere
# ---------------------------------------------------------------------------


class SphereQuadrature:
    """Gauss-Legendre (theta) x trapezoid (phi) product grid on S^2.

    Static, host-precomputed node data. ``weights`` are solid-angle weights
    summing to 4*pi: w_gl(theta) * (2 pi / n_phi), where w_gl already
    includes the sin(theta) Jacobian via the cos(theta) substitution.
    """

    def __init__(self, n_theta: int, n_phi: int, dtype=jnp.float32):
        xs, ws = roots_legendre(n_theta)  # nodes in cos(theta) on [-1, 1]
        theta = np.arccos(xs)[::-1]  # increasing theta
        w_t = ws[::-1]
        phi = (np.arange(n_phi) + 0.5) * (2.0 * np.pi / n_phi)
        tt, pp = np.meshgrid(theta, phi, indexing="ij")
        wt, _ = np.meshgrid(w_t, phi, indexing="ij")
        self.n_theta = n_theta
        self.n_phi = n_phi
        self.n_nodes = n_theta * n_phi
        self.theta = jnp.asarray(tt.ravel(), dtype=dtype)
        self.phi = jnp.asarray(pp.ravel(), dtype=dtype)
        self.weights = jnp.asarray(
            (wt * (2.0 * np.pi / n_phi)).ravel(), dtype=dtype
        )
        st, ct = np.sin(tt.ravel()), np.cos(tt.ravel())
        sp, cp = np.sin(pp.ravel()), np.cos(pp.ravel())
        # Unit direction vectors n_hat [G, 3].
        self.dirs = jnp.asarray(
            np.stack([st * cp, st * sp, ct], axis=-1), dtype=dtype
        )


def default_quadrature(lmax: int, oversample: int = 2, dtype=jnp.float32):
    """Quadrature exact for products of degree-lmax surfaces.

    ``n_theta = oversample*(lmax+1)`` GL nodes integrate polynomials up to
    degree 2*n_theta-1 in cos(theta); phi trapezoid with
    ``n_phi = 2*n_theta`` is exact for trig degree < n_phi.
    """
    n_theta = max(oversample * (lmax + 1), 4)
    return SphereQuadrature(n_theta, 2 * n_theta, dtype=dtype)


# ---------------------------------------------------------------------------
# Shape integrals (host/setup path — small, run once per shape type)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("lmax",))
def shape_volume(coeffs, quad_theta, quad_phi, quad_w, lmax: int):
    """V = (1/3) * integral r^3 dOmega by quadrature."""
    Y = real_sh_basis(quad_theta, quad_phi, lmax)
    r = radius_from_basis(coeffs, Y)
    return jnp.sum(quad_w * r**3) / 3.0


@partial(jax.jit, static_argnames=("lmax",))
def shape_inertia(coeffs, quad_theta, quad_phi, quad_w, dirs, lmax: int):
    """Unit-density inertia tensor [3,3] about the origin.

    I_ab = integral (|x|^2 delta_ab - x_a x_b) dV
         = integral dOmega (r^5/5) (delta_ab - n_a n_b).
    """
    Y = real_sh_basis(quad_theta, quad_phi, lmax)
    r = radius_from_basis(coeffs, Y)
    w5 = quad_w * r**5 / 5.0
    nn = dirs[..., :, None] * dirs[..., None, :]  # [G,3,3]
    eye = jnp.eye(3, dtype=dirs.dtype)
    return jnp.sum(w5[..., None, None] * (eye - nn), axis=0)


@partial(jax.jit, static_argnames=("lmax",))
def shape_centroid(coeffs, quad_theta, quad_phi, quad_w, dirs, lmax: int):
    """Center of mass (unit density): integral x dV / V = (1/4V) int r^4 n dOmega."""
    Y = real_sh_basis(quad_theta, quad_phi, lmax)
    r = radius_from_basis(coeffs, Y)
    vol = jnp.sum(quad_w * r**3) / 3.0
    com = jnp.sum((quad_w * r**4 / 4.0)[:, None] * dirs, axis=0)
    return com / vol


def shape_rmax(coeffs, lmax: int, n_scan: int = 96) -> float:
    """Conservative bounding-sphere radius: dense scan plus 1% margin."""
    q = SphereQuadrature(n_scan, 2 * n_scan, dtype=jnp.float64 if
                         jax.config.read("jax_enable_x64") else jnp.float32)
    Y = real_sh_basis(q.theta, q.phi, lmax)
    r = radius_from_basis(jnp.asarray(coeffs), Y)
    return float(jnp.max(r)) * 1.001


# ---------------------------------------------------------------------------
# Precomputed radius tables (the fast narrow-phase path)
# ---------------------------------------------------------------------------


def build_radius_table(coeffs, lmax: int, n_theta: int = 64, n_phi: int = 128):
    """Tabulate (r, dr/dtheta, dr/dphi) on a uniform cell-centered grid.

    Grid: theta_i = (i+0.5) * pi/n_theta, phi_j = (j+0.5) * 2pi/n_phi —
    cell-centered so poles are never sampled and phi wraps periodically.

    Returns [3, n_theta, n_phi] (stacked r / dr_dt / dr_dp), suitable for
    ``interp_radius``. coeffs may be [NC] or [T, NC] (then [T, 3, nt, np]).
    """
    th = (jnp.arange(n_theta) + 0.5) * (math.pi / n_theta)
    ph = (jnp.arange(n_phi) + 0.5) * (2.0 * math.pi / n_phi)
    tt, pp = jnp.meshgrid(th, ph, indexing="ij")
    Y, dYt, dYp = real_sh_basis_grad(tt, pp, lmax)

    def one(c):
        r = radius_from_basis(c, Y)
        drt = radius_from_basis(c, dYt)
        drp = radius_from_basis(c, dYp)
        return jnp.stack([r, drt, drp], axis=0)

    coeffs = jnp.asarray(coeffs)
    if coeffs.ndim == 1:
        return one(coeffs)
    return jax.vmap(one)(coeffs)


def interp_radius(table, theta, phi):
    """Bilinear lookup of (r, dr/dtheta, dr/dphi) from a radius table.

    table: [3, nt, np] (cell-centered grid from ``build_radius_table``).
    theta/phi: arrays of any shape. Returns three arrays shaped like theta.
    phi wraps periodically; theta clamps at the pole-adjacent rows (the
    table is cell-centered so clamping spans < half a cell of angle).
    """
    nt, npp = table.shape[-2], table.shape[-1]
    ft = theta * (nt / math.pi) - 0.5
    fp = (phi % (2.0 * math.pi)) * (npp / (2.0 * math.pi)) - 0.5
    i0 = jnp.clip(jnp.floor(ft), 0, nt - 1).astype(jnp.int32)
    i1 = jnp.clip(i0 + 1, 0, nt - 1)
    wt = jnp.clip(ft - i0, 0.0, 1.0)
    j0f = jnp.floor(fp)
    wp = fp - j0f
    j0 = jnp.mod(j0f.astype(jnp.int32), npp)
    j1 = jnp.mod(j0 + 1, npp)

    def gather(c):
        t = table[c]
        v00 = t[i0, j0]
        v01 = t[i0, j1]
        v10 = t[i1, j0]
        v11 = t[i1, j1]
        return (
            v00 * (1 - wt) * (1 - wp)
            + v01 * (1 - wt) * wp
            + v10 * wt * (1 - wp)
            + v11 * wt * wp
        )

    return gather(0), gather(1), gather(2)


def interp_radius_batched(tables, types, theta, phi):
    """Bilinear (r, dr/dt, dr/dp) lookup for per-element shape types.

    tables: [T, 3, nt, np]; types: [...]; theta/phi: [..., G] (or any shape
    broadcastable with types[..., None]). Gathers single table entries by
    (type, channel, i, j) — never materializes per-element table copies
    (the naive ``tables[types]`` gather is O(P * table_size) memory).
    """
    nt, npp = tables.shape[-2], tables.shape[-1]
    ft = theta * (nt / math.pi) - 0.5
    fp = (phi % (2.0 * math.pi)) * (npp / (2.0 * math.pi)) - 0.5
    i0 = jnp.clip(jnp.floor(ft), 0, nt - 1).astype(jnp.int32)
    i1 = jnp.clip(i0 + 1, 0, nt - 1)
    wt = jnp.clip(ft - i0, 0.0, 1.0)
    j0f = jnp.floor(fp)
    wp = fp - j0f
    j0 = jnp.mod(j0f.astype(jnp.int32), npp)
    j1 = jnp.mod(j0 + 1, npp)
    tt = types[..., None] if types.ndim == theta.ndim - 1 else types

    def gather(c):
        v00 = tables[tt, c, i0, j0]
        v01 = tables[tt, c, i0, j1]
        v10 = tables[tt, c, i1, j0]
        v11 = tables[tt, c, i1, j1]
        return (
            v00 * (1 - wt) * (1 - wp)
            + v01 * (1 - wt) * wp
            + v10 * wt * (1 - wp)
            + v11 * wt * wp
        )

    return gather(0), gather(1), gather(2)


def surface_normal(r, dr_dt, dr_dp, theta, phi):
    """Angle-API wrapper over surface_normal_trig."""
    return surface_normal_trig(
        r, dr_dt, dr_dp,
        jnp.cos(theta), jnp.sin(theta), jnp.cos(phi), jnp.sin(phi),
    )


def surface_normal_trig(r, dr_dt, dr_dp, ct, st, cp, sp):
    """Outward unit normal of the surface p = r(theta,phi) * e_r.

    n_unnorm = e_r - (dr/dtheta / r) e_theta - (dr/dphi / (r sin t)) e_phi.
    Returns [..., 3] unit normals; takes trig components directly.
    """
    e_r = jnp.stack([st * cp, st * sp, ct], axis=-1)
    e_t = jnp.stack([ct * cp, ct * sp, -st], axis=-1)
    e_p = jnp.stack([-sp, cp, jnp.zeros_like(sp)], axis=-1)
    inv_r = 1.0 / jnp.maximum(r, 1e-12)
    inv_rs = inv_r / jnp.maximum(jnp.abs(st), 1e-6)
    n = (
        e_r
        - (dr_dt * inv_r)[..., None] * e_t
        - (dr_dp * inv_rs)[..., None] * e_p
    )
    return n / jnp.linalg.norm(n, axis=-1, keepdims=True).clip(1e-12)
