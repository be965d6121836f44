"""Power-basis (monomial) SH tables == scipy-pinned basis contraction.

The hot kernels evaluate the radius field via per-type Horner tables
(ops/sh_power.py); this pins those tables against the scipy-validated
basis evaluators (ops/sh_np.py) and checks f32 conditioning at lmax=8
(SURVEY.md 2 B.4 SH math helper).
"""

import numpy as np
import pytest

from spherharm_tpu.models import shapes_library
from spherharm_tpu.ops import sh_np, sh_power


@pytest.mark.parametrize("lmax", [0, 2, 4, 8])
def test_power_tables_match_basis(lmax):
    coeffs = np.stack(
        [
            shapes_library.blob_coeffs(
                lmax, seed=t, mean_radius=0.5, roughness=0.12
            )
            for t in range(2)
        ]
        + [shapes_library.sphere_coeffs(0.4, lmax)]
    )
    if lmax >= 2:
        coeffs = np.concatenate(
            [coeffs, shapes_library.ellipsoid_coeffs(
                0.55, 0.45, 0.4, lmax)[None]]
        )
    tbl = sh_power.build_power_tables_np(coeffs, lmax)
    rng = np.random.default_rng(3)
    theta = rng.uniform(1e-3, np.pi - 1e-3, 400)
    phi = rng.uniform(0.0, 2 * np.pi, 400)
    Y, dYt, dYp = sh_np.real_sh_basis_grad_np(theta, phi, lmax)
    for t in range(coeffs.shape[0]):
        r, drt, drp = sh_power.eval_power_np(tbl[t], theta, phi, lmax)
        np.testing.assert_allclose(r, Y @ coeffs[t], rtol=0, atol=1e-11)
        np.testing.assert_allclose(drt, dYt @ coeffs[t], rtol=0, atol=1e-10)
        np.testing.assert_allclose(drp, dYp @ coeffs[t], rtol=0, atol=1e-10)


def test_f32_conditioning_lmax8():
    """Monomial Horner in f32 stays at ~1e-6 relative at lmax=8 (the
    conditioning worry that rules the basis choice)."""
    lmax = 8
    c = shapes_library.blob_coeffs(lmax, seed=0, mean_radius=0.5,
                                   roughness=0.12)
    tbl = sh_power.build_power_tables_np(c, lmax).astype(np.float32)
    rng = np.random.default_rng(1)
    theta = rng.uniform(0, np.pi, 2000)
    phi = rng.uniform(0, 2 * np.pi, 2000)
    Y, dYt, dYp = sh_np.real_sh_basis_grad_np(theta, phi, lmax)
    r, drt, drp = sh_power.eval_power(
        tbl,
        np.cos(theta).astype(np.float32),
        np.sin(theta).astype(np.float32),
        np.cos(phi).astype(np.float32),
        np.sin(phi).astype(np.float32),
        lmax,
    )
    scale = np.abs(Y @ c).max()
    assert np.abs(r - Y @ c).max() / scale < 1e-5
    assert np.abs(drt - dYt @ c).max() / scale < 1e-5


def test_pole_regularity():
    """The power form is polynomial at the poles: drt finite and -> 0
    for m=0-only shapes' transverse component, drp -> 0."""
    lmax = 8
    c = shapes_library.blob_coeffs(lmax, seed=2, mean_radius=0.5,
                                   roughness=0.12)
    tbl = sh_power.build_power_tables_np(c, lmax)
    theta = np.array([1e-9, np.pi - 1e-9])
    phi = np.array([0.7, 2.1])
    r, drt, drp = sh_power.eval_power_np(tbl, theta, phi, lmax)
    assert np.all(np.isfinite(r)) and np.all(r > 0.2)
    assert np.all(np.abs(drt) < 1e-6)
    assert np.all(np.abs(drp) < 1e-6)


def test_shapes_carry_power_tables():
    shapes = shapes_library.build_shapes(
        [shapes_library.blob_coeffs(8, seed=0, mean_radius=0.5)],
        8, contact_quad=(8, 16),
    )
    lay = sh_power.power_layout(8)
    assert shapes.power_tbl.shape == (1, lay["W"])
    assert float(shapes.gmax[0]) > 0
    sph = shapes_library.build_shapes(
        [shapes_library.sphere_coeffs(0.5, 0)], 0)
    assert float(sph.gmax[0]) == 0.0
