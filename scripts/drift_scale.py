"""Energy drift at representative scale: N >= 10k Lmax=8 blobs, NVE.

VERDICT.md round-2 item 3: the 4-body collider (drift_lmax8.py) probes
the force law, not the metric point — BASELINE.json:2 defines drift at
large N with real contact churn. This harness runs a dense periodic
undamped frictionless NVE gas of Lmax=8 blobs through the FULL
production path (prefiltered pair list), conservative (exact-gradient)
elastic mode by default.

At this density the system is never in free flight, so etot (ke + erot
+ pe_pair) is sampled every block and the secular drift is the SLOPE of
a linear fit over samples — the quadrature PE-vs-force mismatch is a
bounded bias (~constant offset at steady contact count), not a slope.

Usage: python scripts/drift_scale.py [n_steps] [block] [n]
Env: DRIFT_DT (1e-4), DRIFT_CONSERVATIVE (1), DRIFT_PHI (0.35 packing
     fraction), DRIFT_V0 (0.6), DRIFT_CKPT (restart path, default
     drift_scale_ckpt.npz).
Writes a restart every 10 blocks (resume by rerunning; auto-detected);
`touch drift_stop` checkpoints and exits between blocks.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, ".")

from spherharm_tpu.core.simulation import Simulation  # noqa: E402
from spherharm_tpu.core.state import SimParams  # noqa: E402
from spherharm_tpu.models import scenarios, shapes_library  # noqa: E402

CKPT = os.environ.get("DRIFT_CKPT", "drift_scale_ckpt.npz")


def build(n, seed=0):
    dt = float(os.environ.get("DRIFT_DT", 1e-4))
    v0 = float(os.environ.get("DRIFT_V0", 0.6))
    phi = float(os.environ.get("DRIFT_PHI", 0.35))
    lmax = 8
    rng = np.random.default_rng(seed)
    coeffs = [
        shapes_library.blob_coeffs(lmax, seed=s, roughness=0.12)
        for s in (3, 5)
    ]
    shapes = shapes_library.build_shapes(coeffs, lmax, contact_quad=(8, 16))
    rmax = float(np.max(np.asarray(shapes.rmax)))
    vol = float(np.mean(np.asarray(shapes.vol)))
    params = SimParams.create(
        dt=dt, kn=1e5, gamma_n=0.0, mu=0.0,
        skin=0.25 * rmax, cutoff=2.0 * rmax * 1.02,
    )
    # Jittered grid start: free (non-overlapping) at t=0, collides
    # within a few hundred steps everywhere. The pitch must clear the
    # particle diameter, which caps the reachable packing fraction on a
    # cubic grid (~0.2 for rough blobs) — requested phi beyond that is
    # clamped rather than starting interpenetrated.
    m = int(np.ceil(n ** (1 / 3)))
    pitch = max((vol / phi) ** (1.0 / 3.0), 2.12 * rmax)
    box = m * pitch
    idx = np.arange(m ** 3)[:n]
    pts = np.stack([idx % m, (idx // m) % m, idx // (m * m)], axis=1)
    x = (pts + 0.5) * pitch
    x += rng.uniform(-0.04, 0.04, x.shape) * (pitch - 2.0 * rmax)
    v = rng.normal(size=(n, 3))
    v *= v0 / np.linalg.norm(v, axis=1, keepdims=True)
    v -= v.mean(axis=0)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    state = scenarios.make_state(
        x, [0, 0, 0], [box] * 3, v=v, q=q,
        shtype=rng.integers(0, 2, n).astype(np.int32),
    )
    from spherharm_tpu.ops.neighbor import CellGrid

    grid = CellGrid([0, 0, 0], [box] * 3,
                    float(params.cutoff) + float(params.skin),
                    (True,) * 3)
    sim = Simulation(
        shapes, params, periodic=(True,) * 3, neighbor_mode="cell",
        grid=grid, k_max=24, cell_cap=16,
        pair_capacity=6 * n,
        stage2_capacity=3 * n,
        conservative=os.environ.get("DRIFT_CONSERVATIVE", "1") == "1",
    )
    return sim, state


def main():
    n_steps = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    block = int(sys.argv[2]) if len(sys.argv) > 2 else 2_000
    n = int(sys.argv[3]) if len(sys.argv) > 3 else 10_000
    sim, state = build(n)

    from spherharm_tpu.io import restart as restart_io

    done = 0
    samples = []
    if os.path.exists(CKPT):
        st2, ng2, _, extra = restart_io.read_restart(CKPT)
        state, neigh = st2, ng2
        done = int(extra["done"])
        samples = [tuple(row) for row in extra["samples"]]
        print(f"# resumed at step {done}", flush=True)
    else:
        state, neigh = sim.init_neighbors(state)

    t0 = sim.thermo(state, neigh)
    e0 = float(t0["etot"])
    print(f"# n={n} steps={n_steps} block={block} "
          f"conservative={sim.conservative}",
          flush=True)
    print(f"# e[{done}] = {e0:.8g} (ke {float(t0['ke']):.6g} "
          f"erot {float(t0['erot']):.6g} pe {float(t0['pe_pair']):.6g})",
          flush=True)

    nblk = 0
    while done < n_steps:
        tw = time.time()
        state, neigh = sim.run(state, neigh, block)
        done += block
        nblk += 1
        t = sim.thermo(state, neigh)
        e = float(t["etot"])
        samples.append((done, e))
        ovf = int(neigh.overflow)
        print(f"step {done:>9d}  etot {e:.8g}  pe {float(t['pe_pair']):.4g}"
              f"  ovf {ovf}  {block / (time.time() - tw):.0f} steps/s",
              flush=True)
        if ovf != 0:
            print("# FATAL: overflow — truncated physics", flush=True)
            sys.exit(1)
        if nblk % 10 == 0:
            restart_io.write_restart(
                CKPT, state, neigh, sim.params,
                extra={"done": done, "samples": np.asarray(samples)},
            )
            if len(samples) > 10:
                s = np.asarray(samples, float)
                slope = np.polyfit(s[:, 0], s[:, 1], 1)[0]
                print(f"# interim drift slope: "
                      f"{slope * 1e6 / abs(s[0, 1]):+.4%} per 1M steps",
                      flush=True)
        # Cooperative pause: `touch drift_stop` checkpoints and exits
        # cleanly between blocks. Rerunning resumes from the ckpt.
        if os.path.exists("drift_stop"):
            restart_io.write_restart(
                CKPT, state, neigh, sim.params,
                extra={"done": done, "samples": np.asarray(samples)},
            )
            print(f"# paused at step {done} (drift_stop)", flush=True)
            sys.exit(0)

    s = np.asarray(samples, float)
    # Secular drift = fitted slope (per step) scaled to 1M steps,
    # relative to the initial energy.
    slope = np.polyfit(s[:, 0], s[:, 1], 1)[0]
    e_ref = abs(s[0, 1])
    per_m = slope * 1e6 / e_ref
    ok = abs(per_m) < 0.01
    print(f"# RESULT (N={n} Lmax=8, fitted slope): {per_m:+.4%} per 1M "
          f"steps ({'PASS' if ok else 'FAIL'} vs <1% target)")


if __name__ == "__main__":
    main()
