"""One-setup cadence/rebuild sweep at bench scale (GPU).

How much of the step budget is the amortized rebuild? This harness
builds the drum ONCE and then measures, sharing
shapes/params/grid/walls across Simulation configs:

  1. block decomposition at R: _run_cadence_jit(r=1) isolates the
     rebuild step as compiled IN the scan (the profiled standalone
     rebuild is NOT the in-program cost — fusion differs), r=R gives
     rebuild + (R-1) plain steps.
  2. bench-style ps/s at each cadence in SWEEP_R (comma env, default
     "20,40,80,0"; 0 = adaptive approach_ratio trigger via lax.cond).
     skin_violations / overflow recorded — a nonzero voids the row.

Usage: [SWEEP_N=100000] [SWEEP_R=20,40,80,0] python scripts/cadence_sweep.py
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from spherharm_tpu.core.simulation import Simulation, _run_cadence_jit
from spherharm_tpu.models import scenarios
from spherharm_tpu.utils import device


def main():
    n = int(os.environ.get("SWEEP_N", 100_000))
    lmax = int(os.environ.get("SWEEP_LMAX", 8))
    rs = [int(r) for r in os.environ.get("SWEEP_R", "20,40,80,0").split(",")]
    _, card = device.require_gpu()
    print(f"# {card}", flush=True)

    t0 = time.time()
    sim0, state0, neigh0 = scenarios.rotating_drum(
        n=n, lmax=lmax, k_max=24,
        pair_capacity=5 * n, stage2_capacity=3 * n,
        rebuild_every=20, conservative=True,
    )
    print(f"# setup {time.time() - t0:.1f}s n={n}", flush=True)

    def clone(rebuild_every):
        return Simulation(
            sim0.shapes, sim0.params, neighbor_mode="cell", grid=sim0.grid,
            k_max=sim0.k_max, cell_cap=sim0.cell_cap, walls=sim0.walls,
            pair_capacity=sim0.pair_capacity,
            rebuild_every=rebuild_every, wall_capacity=sim0.wall_capacity,
            stage2_capacity=sim0.stage2_capacity, conservative=True,
        )

    # Shared warm start: settle 60 steps once on the R=20 program so
    # every row measures the same physical regime as bench.py's window.
    t0 = time.time()
    state, neigh = sim0.run(state0, neigh0, 60)
    jax.block_until_ready(state.x)
    print(f"# warm start (compile+60) {time.time() - t0:.1f}s", flush=True)

    # --- 1. in-program block decomposition at R=20 ------------------
    for r in (1, 20):
        s, ng = _run_cadence_jit(sim0, state, neigh, 1, r)
        jax.block_until_ready(s.x)  # compile
        t0 = time.time()
        reps = 3
        for _ in range(reps):
            s, ng = _run_cadence_jit(sim0, state, neigh, 1, r)
        jax.block_until_ready(s.x)
        dt_ms = (time.time() - t0) / reps * 1e3
        print(f"# block r={r:>2d}: {dt_ms:8.1f} ms "
              f"({'rebuild step alone' if r == 1 else 'rebuild + 19 plain'})",
              flush=True)

    # --- 2. cadence throughput sweep --------------------------------
    for r in rs:
        sim = clone(r)
        st, ng = sim.init_neighbors(state)
        # zero the violation counters inherited from init
        ng = ng.replace(skin_violations=jnp.zeros_like(ng.skin_violations))
        block = 3 * r if r > 0 else 60
        t0 = time.time()
        st, ng = sim.run(st, ng, block)
        jax.block_until_ready(st.x)
        print(f"#   R={r}: compile+{block} {time.time() - t0:.1f}s",
              flush=True)
        n_steps = 0
        t0 = time.time()
        while n_steps < 180:
            st, ng = sim.run(st, ng, block)
            n_steps += block
        jax.block_until_ready(st.x)
        wall = time.time() - t0
        ps = n * n_steps / wall
        print(f"R={r:>2d}  {wall / n_steps * 1e3:7.1f} ms/step  "
              f"{ps:,.0f} ps/s  overflow={int(ng.overflow)} "
              f"skin_viol={int(ng.skin_violations)}", flush=True)


if __name__ == "__main__":
    main()
