"""What the GPU port pins on the CPU: matrix products at full f32
precision (no TF32), the compile-cache location, and the device check
that keeps CPU numbers out of device metrics."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spherharm_tpu.core.simulation import Simulation
from spherharm_tpu.core.state import SimParams, empty_neighbors
from spherharm_tpu.models import scenarios, shapes_library
from spherharm_tpu.ops import contact, integrate, neighbor
from spherharm_tpu.utils import device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dot_precisions(fn, *args):
    """Precision config of every dot_general in fn's jaxpr (nested
    jaxprs included)."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for p in eqn.params.values():
                for j in (p if isinstance(p, (tuple, list)) else [p]):
                    j = getattr(j, "jaxpr", j)   # ClosedJaxpr -> Jaxpr
                    if hasattr(j, "eqns"):
                        walk(j)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


def _is_highest(prec):
    hi = jax.lax.Precision.HIGHEST
    return prec is not None and all(p == hi for p in prec)


def _small_sim(n=16, pair_capacity=64):
    rng = np.random.default_rng(0)
    shapes = shapes_library.build_shapes(
        [shapes_library.ellipsoid_coeffs(0.55, 0.45, 0.4, 2)], 2,
        contact_quad=(6, 12))
    params = SimParams.create(dt=1e-3, kn=1e4, gamma_n=5.0, mu=0.3,
                              cutoff=1.2, skin=0.3, press_tau=1.0)
    x = rng.uniform(0.6, 3.4, (n, 3))
    state = scenarios.make_state(x, [0, 0, 0], [4.0] * 3,
                                 v=rng.normal(size=(n, 3)))
    sim = Simulation(shapes, params, neighbor_mode="allpairs", k_max=8,
                     pair_capacity=pair_capacity, conservative=False)
    return sim, state


def test_remap_history_product_is_highest():
    """The one-hot spring carry must not run in TF32 (it would round the
    springs to ~3 digits at every rebuild)."""
    N, K = 8, 4
    key = jnp.arange(N * K, dtype=jnp.int32).reshape(N, K)
    mask = jnp.ones((N, K), bool)
    hist = jnp.ones((N, K, 6), jnp.float32)
    precs = _dot_precisions(
        lambda *a: neighbor.remap_history(*a, chunk=4),
        key, mask, key, mask, hist)
    assert precs and all(_is_highest(p) for p in precs), precs


@pytest.mark.parametrize("path", ["pairs", "dense"])
def test_virial_products_are_highest(path):
    """Virial einsums of both contact paths (stress output)."""
    sim, state = _small_sim(pair_capacity=64 if path == "pairs" else 0)
    neigh = empty_neighbors(state.cap, sim.k_max,
                            pair_cap=sim.pair_list_cap)
    if path == "pairs":
        fn = lambda s, ng: contact.contact_force_pairs(
            s, sim.shapes, sim.params, ng, exact=True)
    else:
        fn = lambda s, ng: contact.contact_force_dense(
            s, sim.shapes, sim.params, ng, exact=True)
    precs = _dot_precisions(fn, state, neigh)
    assert precs and all(_is_highest(p) for p in precs), precs


def test_kinetic_tensor_products_are_highest():
    """thermo's kinetic stress tensor and the Berendsen servo's kinetic
    term."""
    sim, state = _small_sim(pair_capacity=0)
    neigh = empty_neighbors(state.cap, sim.k_max)
    precs = _dot_precisions(lambda s, ng: sim.thermo(s, ng), state, neigh)
    precs += _dot_precisions(
        lambda s: integrate.berendsen_box_control(
            s, s.x, sim.params, jnp.zeros((3, 3)), sim.shapes)[0].x,
        state)
    assert len(precs) >= 2 and all(_is_highest(p) for p in precs), precs


def _cache_dir_in_child(env_extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "SPHERHARM_JAX_CACHE")}
    env.update(env_extra)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, spherharm_tpu; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
        check=True)
    return out.stdout.strip().splitlines()[-1]


def test_cache_dir_follows_env(tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins; the package sets no other."""
    got = _cache_dir_in_child({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert got == str(tmp_path)


def test_cache_dir_default_is_in_checkout():
    got = _cache_dir_in_child({})
    assert got == os.path.join(ROOT, ".jax_cache")


def test_require_gpu_fails_without_gpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()


def test_chip_smoke_fails_without_gpu():
    """The smoke test exits non-zero and prints no result on the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_bench_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu", BENCH_N="64")
    out = subprocess.run([sys.executable, "bench.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("conservative", [False, True])
def test_contact_law_on_card_matches_cpu(gpu, conservative):
    """The contact law as XLA compiles it for the card agrees with the
    host CPU (f32 both; sums in another order)."""
    lmax, n = 6, 12
    rng = np.random.default_rng(1)
    shapes = shapes_library.build_shapes(
        [shapes_library.blob_coeffs(lmax, seed=t, mean_radius=0.5,
                                    roughness=0.12) for t in range(2)],
        lmax, contact_quad=(8, 16))
    params = SimParams.create(dt=1e-4, kn=1e5, gamma_n=20.0, mu=0.4,
                              k_roll=2e4, gamma_roll=10.0, mu_roll=0.2,
                              cutoff=1.4, skin=0.2)
    state = scenarios.make_state(
        rng.uniform(0.7, 2.3, (n, 3)), [0, 0, 0], [4, 4, 4],
        v=rng.normal(size=(n, 3)) * 0.2, shtype=rng.integers(0, 2, n))
    pi, pj = np.triu_indices(n, 1)
    pi, pj = jnp.asarray(pi, jnp.int32), jnp.asarray(pj, jnp.int32)
    mask = jnp.ones(pi.shape, bool)
    hist = jnp.zeros((pi.shape[0], 6), jnp.float32)

    def run(dev):
        put = lambda a: jax.device_put(a, dev)
        st, sh = put(state), put(shapes)
        rows = contact.particle_rows(st, sh)
        with jax.default_matmul_precision("highest"):
            out = contact.pair_contact_rows(
                rows[put(pi)], rows[put(pj)], st.shtype[put(pi)],
                st.shtype[put(pj)], put(hist), put(mask), st.box_lo,
                st.box_hi, sh, put(params), exact=True,
                conservative=conservative)
        return [np.asarray(a) for a in out[:6]]

    g, c = run(gpu), run(jax.devices("cpu")[0])
    assert c[5].sum() > 3
    np.testing.assert_array_equal(g[5], c[5])
    tol = 1e-4 if conservative else 2e-3
    fmax = np.abs(c[0]).max()
    for k in range(3):
        np.testing.assert_allclose(g[k], c[k], atol=tol * fmax)
    np.testing.assert_allclose(g[4], c[4], atol=tol * c[4].max())
