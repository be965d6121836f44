"""Chunked rebuild == unchunked rebuild (the n=1M single-chip enabler).

The neighbor stencil/filter/top_k stage and the prefilter's full-basis
probe materialize O(N*27*cell_cap) / O(P*81) transients, which run
out of device memory at ~1M particles. Both run through lax.map row blocks;
these pin bit-equality against the unchunked path at a size that forces
several ragged blocks.
"""

import jax.numpy as jnp
import numpy as np

from spherharm_tpu.core.state import SimParams
from spherharm_tpu.models import scenarios, shapes_library
from spherharm_tpu.ops import contact, neighbor


def _system(n=300, box=8.0, seed=2):
    rng = np.random.default_rng(seed)
    lmax = 4
    shapes = shapes_library.build_shapes(
        [shapes_library.blob_coeffs(lmax, seed=t, mean_radius=0.5,
                                    roughness=0.1) for t in range(2)],
        lmax, contact_quad=(8, 16),
    )
    x = rng.uniform(0.0, box, (n, 3))
    state = scenarios.make_state(
        x, [0, 0, 0], [box] * 3,
        v=rng.normal(size=(n, 3)) * 0.4,
        shtype=rng.integers(0, 2, n),
    )
    params = SimParams.create(dt=1e-3, kn=1e4, gamma_n=2.0, mu=0.3,
                              cutoff=1.3, skin=0.3)
    return shapes, params, state


def test_cell_list_chunked_equals_unchunked():
    shapes, params, state = _system()
    kw = dict(
        cutoff=1.6, grid_dims=(5, 5, 5), cell_cap=16, k_max=24,
        periodic=(True, True, True),
    )
    a = neighbor.cell_list_neighbors(
        state.x, state.active, state.box_lo, state.box_hi,
        row_chunk=0, **kw,
    )
    for chunk in (64, 77, 300):
        b = neighbor.cell_list_neighbors(
            state.x, state.active, state.box_lo, state.box_hi,
            row_chunk=chunk, **kw,
        )
        for u, v in zip(a, b):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def test_prefilter_chunked_equals_unchunked():
    shapes, params, state = _system(n=200, box=6.0)
    idx, mask, count, _ = neighbor.cell_list_neighbors(
        state.x, state.active, state.box_lo, state.box_hi,
        cutoff=1.6, grid_dims=(4, 4, 4), cell_cap=24, k_max=24,
        periodic=(True, True, True),
    )
    hist = jnp.zeros((state.cap, 24, 6))
    fields, n_pairs = contact.build_pair_list(
        state, shapes, params, idx, mask, hist,
        state.active, 2048, periodic=(True, True, True),
    )
    outs = []
    for chunk in (0, 256, 500):
        f2, n_surv, budget = contact.prefilter_pair_list(
            state, shapes, params, fields, 512, 24,
            periodic=(True, True, True), probe_chunk=chunk,
        )
        outs.append((f2, int(n_surv), np.asarray(budget)))
    ref = outs[0]
    assert ref[1] > 4  # something survives
    for f2, n_surv, budget in outs[1:]:
        assert n_surv == ref[1]
        np.testing.assert_array_equal(np.asarray(f2["pair_i"]),
                                      np.asarray(ref[0]["pair_i"]))
        np.testing.assert_array_equal(np.asarray(f2["pair_j"]),
                                      np.asarray(ref[0]["pair_j"]))
        np.testing.assert_allclose(budget, ref[2], rtol=1e-6)
