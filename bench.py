"""Throughput benchmark: config 4 rotating drum (BASELINE.json:10).

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ...,
"vs_baseline": N, "device": {...}, "card": ...}. Metric is
particle-steps/sec at Lmax=8 (the primary metric, BASELINE.json:2).
Runs on a GPU or fails: a CPU number is never reported under this name.

vs_baseline: the reference fork publishes no numbers and
its code is not yet mounted, so the denominator is the order-of-
magnitude CPU-DEM estimate recorded in SURVEY.md section 6 (2e4
particle-steps/s/core for expensive non-spherical contact); replace
with the measured CPU-LAMMPS figure when the reference becomes
buildable. The task target is >= 50x that baseline.

Env knobs: BENCH_N (default 100000), BENCH_LMAX (8), BENCH_STEPS (200),
BENCH_STAGE2, BENCH_PAIR_CAP.
"""

from __future__ import annotations

import json
import os
import sys
import time

CPU_LAMMPS_BASELINE_EST = 2.0e4  # particle-steps/s, SURVEY.md section 6


def main():
    import jax

    from spherharm_tpu.models import scenarios
    from spherharm_tpu.utils import device

    try:
        devs, card = device.require_gpu()
    except RuntimeError as e:
        raise SystemExit(f"bench.py: {e}")

    n = int(os.environ.get("BENCH_N", 100_000))
    lmax = int(os.environ.get("BENCH_LMAX", 8))
    n_steps = int(os.environ.get("BENCH_STEPS", 200))

    # Rebuild-time prefilter: the per-step narrow phase runs only on
    # near-contact pairs (~3 true contacts/particle half-list in a dense
    # bed; the probe's margins add a few tenths more; 3n covers it and
    # overflow fails the bench loudly below if it ever saturates).
    stage2 = int(os.environ.get("BENCH_STAGE2", 3 * n))
    # Half-list candidates in a dense random packing run ~4-5/particle
    # (measured: 0.8/particle loose, ~3 settled; the old 10n default
    # made 90%+ of all pair-stage work masked padding). Overflow fails
    # the bench loudly below if 5n ever saturates.
    pair_cap = int(os.environ.get("BENCH_PAIR_CAP", 5 * n))
    # Conservative (exact-gradient) elastic force is the DEFAULT: the
    # contract couples throughput AND <1%/1M drift in one sentence
    # (BASELINE.json:5), so the published number is the accuracy mode's.
    # BENCH_CONSERVATIVE=0 measures the geometric path.
    conservative = os.environ.get("BENCH_CONSERVATIVE", "1") == "1"
    # Rebuild-transient chunking (stencil rows + prefilter probe)
    # exists only to bound the n~1M transient working set (the round-4
    # n=1M run RESOURCE_EXHAUSTED). Simulation's auto policy (see
    # core/simulation.py rebuild_chunk) is unchunked up to
    # pair_capacity ~1.5M and 262144-row chunks beyond;
    # BENCH_REBUILD_CHUNK overrides it (0 = force unchunked).
    rebuild_chunk_env = os.environ.get("BENCH_REBUILD_CHUNK")
    rebuild_every = int(os.environ.get("BENCH_REBUILD_EVERY", 20))
    t0 = time.time()
    sim, state, neigh = scenarios.rotating_drum(
        n=n, lmax=lmax,
        pair_chunk=int(os.environ.get("BENCH_PAIR_CHUNK", 0)),
        k_max=24,
        pair_capacity=pair_cap,
        rebuild_every=rebuild_every,
        stage2_capacity=stage2,
        conservative=conservative,
        rebuild_chunk=(None if rebuild_chunk_env is None
                       else int(rebuild_chunk_env)),
    )
    setup_s = time.time() - t0
    print(f"# setup {setup_s:.1f}s  n={n} lmax={lmax} "
          f"grid={sim.grid.dims} pair_cap={sim.pair_capacity} ({card})",
          file=sys.stderr)

    # One compile: warm up and measure with the SAME block length.
    # Default block = a multiple of the rebuild cadence so run() stays
    # on the single statically scheduled cadence program (a remainder
    # adds one extra rebuild + a second compiled program).
    default_block = 3 * rebuild_every if rebuild_every > 0 else 50
    block = int(os.environ.get("BENCH_BLOCK", default_block))
    t0 = time.time()
    state, neigh = sim.run(state, neigh, block)
    jax.block_until_ready(state.x)
    print(f"# compile+{block} steps {time.time() - t0:.1f}s", file=sys.stderr)

    n_blocks = max(n_steps // block, 1)
    t0 = time.time()
    for _ in range(n_blocks):
        state, neigh = sim.run(state, neigh, block)
    jax.block_until_ready(state.x)
    wall = time.time() - t0
    n_steps = n_blocks * block
    ps_per_s = n * n_steps / wall
    overflow = int(neigh.overflow)
    skin_viol = int(neigh.skin_violations)
    therm = sim.thermo(state, neigh)
    print(
        f"# {n_steps} steps in {wall:.2f}s; overflow={overflow} "
        f"skin_violations={skin_viol} etot={float(therm['etot']):.6g}",
        file=sys.stderr,
    )
    # Static cadence only RECORDS displacement-budget violations (it
    # never branches); a nonzero count means the pair list may have
    # missed a contact between rebuilds — the number is void.
    if skin_viol != 0:
        print(f"# FATAL: {skin_viol} skin violations at cadence "
              f"{sim.rebuild_every} — raise the rebuild rate", file=sys.stderr)
        sys.exit(1)
    # The overflow channel is per-source gated (each count contributes
    # only when it exceeds its OWN capacity — see Simulation._build_list)
    # so ANY nonzero value means physics was silently truncated — fail
    # loudly rather than publish a number from a truncated run.
    if overflow != 0:
        print(f"# FATAL: capacity overflow (channel={overflow}) "
              "— truncated physics, bench void", file=sys.stderr)
        sys.exit(1)
    import math
    if not math.isfinite(float(therm["etot"])):
        print("# FATAL: non-finite energy", file=sys.stderr)
        sys.exit(1)

    print(json.dumps({
        "metric": f"particle-steps/sec, {n} Lmax={lmax} rotating drum",
        "value": round(ps_per_s, 1),
        "unit": "particle-steps/s",
        "vs_baseline": round(ps_per_s / CPU_LAMMPS_BASELINE_EST, 2),
        "device": device.describe(devs),
        "card": card,
    }))


if __name__ == "__main__":
    main()
