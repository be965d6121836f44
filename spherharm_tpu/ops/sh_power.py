"""Power-basis (monomial) factorization of the real-SH radius field.

The hot kernels evaluate r(theta, phi) = sum_nm c_nm Y_nm and its first
angular derivatives at quadrature nodes. The streaming ALP recurrence
(ops/sh_math.py) recomputes the
associated-Legendre chain per node: ~60% of its FLOPs are basis
recurrence overhead that is independent of the coefficients.

This module removes that overhead by absorbing the coefficients into
per-type polynomial tables at SETUP time (the reference's per-shape
precompute slot, SURVEY.md 2 B.2). Using P~_n^m(ct) = st^m p_nm(ct)
with p_nm a degree-(n-m) polynomial:

  r(t, p)      = sum_m st^m  [cos(mp) A_m(ct) + sin(mp) B_m(ct)]
  dr/dtheta    = sum_{m>=1} st^(m-1) [cos(mp) At_m(ct) + sin(mp) Bt_m(ct)]
                 + st * At_0(ct)
  dr/dphi      = sum_m m st^m [cos(mp) B_m(ct) - sin(mp) A_m(ct)]

where (with kappa_0 = 1, kappa_m = sqrt(2) for m >= 1):

  A_m  = sum_n kappa_m c_{n, m} p_nm        (degree lmax - m)
  B_m  = sum_n kappa_m c_{n,-m} p_nm
  At_m = m ct A_m - (1 - ct^2) A_m'         (degree lmax - m + 1, m >= 1)
  At_0 = -A_0'                              (drt|_{m=0} = -st A_0'(ct))

All tables are linear in the coefficients, so per-particle scale is one
multiply on the gathered row. Per node the evaluation is pure Horner +
the cos/sin(m phi) and st^m recurrences: ~3x fewer FLOPs than the ALP
chain, with NO accuracy compromise (same function, different basis;
monomial conditioning at lmax = 8 costs ~<=1e-5 relative in f32 — the
parity test pins it). The theta-derivative is exactly polynomial at the
poles (no 1/sin theta guard).
"""

from __future__ import annotations

import math

import numpy as np


def power_layout(lmax: int):
    """Flat row layout: per-m Horner coefficient runs, high degree first.

    Returns dict with, for each table ('A', 'B', 'At', 'Bt'), a list of
    (m, offset, length) and total width 'W'. B/Bt runs exist for m >= 1.
    """
    runs = {"A": [], "B": [], "At": [], "Bt": []}
    off = 0
    for m in range(lmax + 1):
        n = lmax - m + 1
        runs["A"].append((m, off, n))
        off += n
    for m in range(1, lmax + 1):
        n = lmax - m + 1
        runs["B"].append((m, off, n))
        off += n
    for m in range(lmax + 1):
        n = max(lmax, 1) if m == 0 else lmax - m + 2
        runs["At"].append((m, off, n))
        off += n
    for m in range(1, lmax + 1):
        n = lmax - m + 2
        runs["Bt"].append((m, off, n))
        off += n
    return {"runs": runs, "W": off}


def _alp_poly_coeffs(lmax: int):
    """Monomial coefficients (low->high in ct) of p_nm = P~_n^m / st^m.

    Same fully-normalized (4pi-orthonormal) convention and recurrences
    as the streaming evaluators (ops/sh_math.py). float64.
    Returns dict[(n, m)] -> np.ndarray.
    """
    polys = {}
    for m in range(lmax + 1):
        c0 = 1.0 / math.sqrt(4.0 * math.pi)
        for k in range(1, m + 1):
            c0 *= math.sqrt((2 * k + 1) / (2.0 * k))
        p_mm = np.array([c0])
        polys[(m, m)] = p_mm
        if m + 1 <= lmax:
            polys[(m + 1, m)] = math.sqrt(2 * m + 3) * np.concatenate(
                [[0.0], p_mm]
            )
        for n in range(m + 2, lmax + 1):
            a = math.sqrt((4 * n * n - 1) / (n * n - m * m))
            b = math.sqrt(
                ((2 * n + 1) / (2 * n - 3))
                * ((n - 1) ** 2 - m * m)
                / (n * n - m * m)
            )
            pa = np.concatenate([[0.0], polys[(n - 1, m)]]) * a
            pb = polys[(n - 2, m)]
            out = pa.copy()
            out[: len(pb)] -= b * pb
            polys[(n, m)] = out
    return polys


def _poly_deriv(p):
    if len(p) <= 1:
        return np.zeros(1)
    return p[1:] * np.arange(1, len(p))


def _padd(a, b):
    out = np.zeros(max(len(a), len(b)))
    out[: len(a)] += a
    out[: len(b)] += b
    return out


def build_power_tables_np(coeffs, lmax: int) -> np.ndarray:
    """[T, NC] real SH coefficient rows -> [T, W] flat power tables."""
    from spherharm_tpu.models.shapes_library import sh_index

    coeffs = np.atleast_2d(np.asarray(coeffs, np.float64))
    T = coeffs.shape[0]
    lay = power_layout(lmax)
    polys = _alp_poly_coeffs(lmax)
    tbl = np.zeros((T, lay["W"]))
    sq2 = math.sqrt(2.0)
    for t in range(T):
        A, B = {}, {}
        for m in range(lmax + 1):
            kap = 1.0 if m == 0 else sq2
            pa = np.zeros(1)
            pb = np.zeros(1)
            for n in range(m, lmax + 1):
                pa = _padd(pa, kap * coeffs[t, sh_index(n, m)] * polys[(n, m)])
                if m > 0:
                    pb = _padd(
                        pb, kap * coeffs[t, sh_index(n, -m)] * polys[(n, m)]
                    )
            A[m] = pa
            B[m] = pb

        def tilde(p, m):
            # m ct p - (1 - ct^2) p'
            dp = _poly_deriv(p)
            out = _padd(
                m * np.concatenate([[0.0], p]),
                -dp,
            )
            return _padd(out, np.concatenate([[0.0, 0.0], dp]))

        def put(run_m, off, n, p):
            # Horner order: HIGH degree first, padded at the high end.
            while len(p) > 1 and p[-1] == 0.0:
                p = p[:-1]
            if len(p) > n:
                raise AssertionError(
                    f"poly length {len(p)} > run {n} (m={run_m})"
                )
            q = np.zeros(n)
            q[n - len(p):] = p[::-1]
            tbl[t, off: off + n] = q

        runs = lay["runs"]
        for m, off, n in runs["A"]:
            put(m, off, n, A[m])
        for m, off, n in runs["B"]:
            put(m, off, n, B[m])
        for m, off, n in runs["At"]:
            p = -_poly_deriv(A[0]) if m == 0 else tilde(A[m], m)
            put(m, off, n, p)
        for m, off, n in runs["Bt"]:
            put(m, off, n, tilde(B[m], m))
    return tbl


def eval_power(tbl, ct, st, cp, sp, lmax: int, xp=np):
    """Evaluate (r, dr/dtheta, dr/dphi) from flat power-table rows.

    tbl: [..., W] (leading dims broadcast against the node arrays);
    ct/st/cp/sp: node trig arrays. Written against a generic array
    module ``xp`` (numpy for tests/setup, jnp inside traced code).
    """
    lay = power_layout(lmax)
    runs = lay["runs"]

    def horner(off, n):
        acc = tbl[..., off: off + 1]
        for k in range(1, n):
            acc = acc * ct + tbl[..., off + k: off + k + 1]
        return acc

    A = {m: horner(off, n) for m, off, n in runs["A"]}
    B = {m: horner(off, n) for m, off, n in runs["B"]}
    At = {m: horner(off, n) for m, off, n in runs["At"]}
    Bt = {m: horner(off, n) for m, off, n in runs["Bt"]}

    r = A[0] + xp.zeros_like(ct)
    drt = st * At[0]
    drp = xp.zeros_like(ct)
    cos_m, sin_m = cp, sp
    st_m1 = xp.ones_like(st)          # st^(m-1)
    for m in range(1, lmax + 1):
        if m > 1:
            cos_m, sin_m = cos_m * cp - sin_m * sp, sin_m * cp + cos_m * sp
            # NOTE: must use the OLD cos_m in the sin update — handled
            # by tuple assignment above.
        st_m = st_m1 * st
        r = r + st_m * (cos_m * A[m] + sin_m * B[m])
        drt = drt + st_m1 * (cos_m * At[m] + sin_m * Bt[m])
        drp = drp + m * st_m * (cos_m * B[m] - sin_m * A[m])
        st_m1 = st_m
    return r, drt, drp


def eval_power_radius(tbl, ct, st, cp, sp, lmax: int, xp=np):
    """r only, from the A/B prefix of power-table rows: the first
    (lmax+1)^2 columns of the layout, so a table sliced to that width
    is enough (the rebuild-time prefilter probe)."""
    runs = power_layout(lmax)["runs"]

    def horner(off, n):
        acc = tbl[..., off: off + 1]
        for k in range(1, n):
            acc = acc * ct + tbl[..., off + k: off + k + 1]
        return acc

    _, off0, n0 = runs["A"][0]
    r = horner(off0, n0) + xp.zeros_like(ct)
    cos_m, sin_m = cp, sp
    st_m = xp.ones_like(st)
    for m in range(1, lmax + 1):
        if m > 1:
            cos_m, sin_m = cos_m * cp - sin_m * sp, sin_m * cp + cos_m * sp
        st_m = st_m * st
        _, off_a, n_a = runs["A"][m]
        _, off_b, n_b = runs["B"][m - 1]
        r = r + st_m * (cos_m * horner(off_a, n_a)
                        + sin_m * horner(off_b, n_b))
    return r


def eval_power_np(tbl, theta, phi, lmax: int):
    """Numpy convenience twin on (theta, phi) angle arrays."""
    ct, st = np.cos(theta), np.sin(theta)
    cp, sp = np.cos(phi), np.sin(phi)
    return eval_power(
        np.asarray(tbl), ct, st, cp, sp, lmax, xp=np
    )
