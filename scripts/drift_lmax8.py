"""Energy drift at the METRIC point: Lmax=8 aspherical particles.

BASELINE.json:2 defines drift at Lmax=8 — there the plausible drift
source is the cap-quadrature contact discretization (patch-local
integration of an aspherical surface), not the integrator, so the
2-sphere collider in drift.py is not sufficient evidence. This harness
runs four Lmax=8 blob particles in a small fully-periodic box, undamped
and frictionless (pure NVE), colliding thousands of times per million
steps through the full streaming-ALP narrow phase.

Energy is sampled in free flight only (pe_pair == 0): mid-contact
samples fold in the analytic-PE-vs-quadrature-force mismatch, a
bounded bias rather than secular drift.

Usage: python scripts/drift_lmax8.py [n_steps] [block]
  block is also the single-dispatch scan length.
"""

from __future__ import annotations

import sys

import numpy as np

sys.path.insert(0, ".")

from spherharm_tpu.core.simulation import Simulation  # noqa: E402
from spherharm_tpu.core.state import SimParams  # noqa: E402
from spherharm_tpu.models import scenarios, shapes_library  # noqa: E402


def build(dt=None, kn=1e5, lmax=8, v0=0.6, seed=0, quad=None):
    import os

    dt = dt or float(os.environ.get("DRIFT_DT", 1e-4))
    q = quad or int(os.environ.get("DRIFT_QUAD", 10))
    rng = np.random.default_rng(seed)
    coeffs = [
        shapes_library.blob_coeffs(lmax, seed=s, roughness=0.12)
        for s in (3, 5)
    ]
    shapes = shapes_library.build_shapes(
        coeffs, lmax, contact_quad=(q, 2 * q),
    )
    rmax = float(np.max(np.asarray(shapes.rmax)))
    params = SimParams.create(
        dt=dt, kn=kn, gamma_n=0.0, mu=0.0,
        skin=0.25 * rmax, cutoff=2.0 * rmax * 1.02,
    )
    box = 4.4 * rmax  # 4 particles: free at start, collide constantly
    pitch = box / 2.0
    pts, vel, typ = [], [], []
    for i in range(4):
        cx, cy = i % 2, i // 2
        pts.append([(cx + 0.5) * pitch, (cy + 0.5) * pitch,
                    0.5 * box + 0.12 * rmax * (i - 1.5)])
        v = rng.normal(size=3)
        vel.append(v / np.linalg.norm(v) * v0)
        typ.append(i % 2)
    vel = np.asarray(vel)
    vel -= vel.mean(axis=0)  # zero net momentum
    q = rng.normal(size=(4, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    state = scenarios.make_state(
        pts, [0, 0, 0], [box, box, box], v=vel, q=q,
        shtype=np.asarray(typ, np.int32),
    )
    sim = Simulation(
        shapes, params, neighbor_mode="allpairs", k_max=3,
        periodic=(True, True, True),
        conservative=os.environ.get("DRIFT_CONSERVATIVE", "0") == "1",
    )
    state, neigh = sim.init_neighbors(state)
    return sim, state, neigh


def main():
    n_steps = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    block = int(sys.argv[2]) if len(sys.argv) > 2 else 20_000
    sim, state, neigh = build()
    t0 = sim.thermo(state, neigh)
    e0 = float(t0["etot"])
    assert float(t0["pe_pair"]) == 0.0, "must start in free flight"
    print(f"# e0 = {e0:.8g}  (ke {float(t0['ke']):.6g} "
          f"erot {float(t0['erot']):.6g})", flush=True)
    done = 0
    last = None
    n_contact_skip = 0
    while done < n_steps:
        state, neigh = sim.run(state, neigh, block)
        done += block
        t = sim.thermo(state, neigh)
        if float(t["pe_pair"]) > 0:
            n_contact_skip += 1
            continue
        e = float(t["etot"])
        drift = (e - e0) / abs(e0)
        per_m = drift * (1_000_000 / done)
        last = (done, e, per_m)
        print(f"step {done:>9d}  etot {e:.8g}  drift {drift:+.3e}  "
              f"-> {per_m:+.4%} / 1M steps", flush=True)
    assert last is not None, "every sample was mid-contact; shrink block"
    per_m = last[2]
    ok = abs(per_m) < 0.01
    print(f"# skipped {n_contact_skip} mid-contact samples")
    print(f"# RESULT (Lmax=8 aspherical): {per_m:+.4%} per 1M steps "
          f"({'PASS' if ok else 'FAIL'} vs <1% target)")


if __name__ == "__main__":
    main()
