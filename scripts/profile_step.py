"""Per-stage GPU timing of the drum step at bench scale.

Times, separately jitted and block_until_ready'd (the prefilter
probe + candidate compaction run at REBUILD cadence; the per-step path
is row gathers + narrow phase + segment sums):
  step     - one whole step via sim.run
  forces   - contact_force_pairs as the step runs it
  rows     - particle_rows pack
  rebuild  - neighbor rebuild incl. prefilter (amortized /rebuild_every)
  walls    - wall contact stage
  integ    - initial+final integrate

Usage: python scripts/profile_step.py [n] [lmax]
Env: PROF_STAGE2 (pair-list cap, default 3.5n), PROF_CONS (default 1).
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

from spherharm_tpu.models import scenarios
from spherharm_tpu.ops import contact, integrate, walls as walls_mod
from spherharm_tpu.utils import device


def timeit(fn, *args, n=5, warmup=2):
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.time() - t0) / n


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    lmax = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    # Match bench.py's caps EXACTLY by default (3n stage-2, 5n
    # candidates) so every sim.run program rides the bench's cache
    # entries.
    stage2 = int(os.environ.get("PROF_STAGE2", 3 * n))
    pair_cap = int(os.environ.get("PROF_PAIR_CAP", 5 * n))
    cons = os.environ.get("PROF_CONS", "1") == "1"
    _, card = device.require_gpu()
    print(f"# {card}", flush=True)
    sim, state, neigh = scenarios.rotating_drum(
        n=n, lmax=lmax, k_max=24,
        rebuild_every=20, stage2_capacity=stage2, conservative=cons,
        pair_capacity=pair_cap,
    )
    print(f"# n={n} lmax={lmax} cand_cap={sim.pair_capacity} "
          f"pair_list_cap={sim.pair_list_cap} conservative={cons}",
          flush=True)
    # Settle into a representative contact-rich configuration.
    state, neigh = sim.run(state, neigh, 100)
    jax.block_until_ready(state.x)
    print(f"# overflow={int(neigh.overflow)} "
          f"live_pairs={int(jnp.sum(neigh.pair_valid))}/{sim.pair_list_cap}",
          flush=True)

    shapes, params = sim.shapes, sim.params

    t_step = timeit(lambda: sim.run(state, neigh, 1)[0].x)
    print(f"step        {t_step*1e3:8.2f} ms", flush=True)

    rows_f = jax.jit(lambda st: contact.particle_rows(st, shapes))
    t_rows = timeit(lambda: rows_f(state))
    print(f"rows        {t_rows*1e3:8.2f} ms", flush=True)

    @jax.jit
    def full(st, ng):
        return contact.contact_force_pairs(
            st, shapes, params, ng, exact=sim.exact_eval,
            periodic=sim.periodic, chunk=sim.pair_chunk,
            conservative=cons,
        )[0]

    t_full = timeit(lambda: full(state, neigh))
    print(f"forces      {t_full*1e3:8.2f} ms", flush=True)

    # Materialize EVERY rebuild output: returning only .idx lets XLA
    # dead-code-eliminate the pair build, the prefilter probe and the
    # history remap.
    def _reb_all(st, ng):
        st2, ng2 = sim._rebuild(st, ng)
        return (ng2.idx, ng2.hist, ng2.pair_i, ng2.pair_hist,
                ng2.budget, ng2.overflow, st2.x)

    reb = jax.jit(_reb_all)
    t_reb = timeit(lambda: reb(state, neigh), n=3)
    print(f"rebuild     {t_reb*1e3:8.2f} ms  (every {sim.rebuild_every})",
          flush=True)

    # Rebuild pieces (each fully materialized).
    cutoff = float(params.cutoff) + float(params.skin)
    from spherharm_tpu.ops import neighbor as neigh_mod

    cell = jax.jit(lambda st: neigh_mod.cell_list_neighbors(
        st.x, st.active, st.box_lo, st.box_hi, cutoff,
        sim.grid.dims, sim.cell_cap, sim.k_max, sim.periodic,
        row_chunk=sim.rebuild_chunk))
    idx, mask, cnt, covf = cell(state)
    jax.block_until_ready(idx)
    t_cell = timeit(lambda: cell(state)[0], n=3)
    print(f"  cell_list {t_cell*1e3:8.2f} ms", flush=True)

    remap = jax.jit(lambda ng, tags: neigh_mod.remap_history(
        tags, mask, ng.neigh_tag, ng.mask, ng.hist,
        jnp.ones_like(state.tag, bool)))
    neigh_tag = jnp.where(mask, state.tag[idx], 0)
    t_rm = timeit(lambda: remap(neigh, neigh_tag), n=3)
    print(f"  remap     {t_rm*1e3:8.2f} ms", flush=True)

    bpl = jax.jit(lambda st, h: contact.build_pair_list(
        st, shapes, params, idx, mask, h, st.active,
        sim.pair_capacity, sim.periodic)[0]["pair_i"])
    t_bpl = timeit(lambda: bpl(state, neigh.hist), n=3)
    print(f"  pair_build{t_bpl*1e3:8.2f} ms", flush=True)

    if sim.prefilter:
        fields, n_pairs = contact.build_pair_list(
            state, shapes, params, idx, mask, neigh.hist, state.active,
            sim.pair_capacity, sim.periodic)
        jax.block_until_ready(fields["pair_i"])

        pref = jax.jit(lambda fl: contact.prefilter_pair_list(
            state, shapes, params, fl, sim.stage2_capacity, sim.k_max,
            window_steps=sim._window_steps, periodic=sim.periodic,
            probe_chunk=sim.rebuild_chunk)[0]["pair_i"])
        t_pref = timeit(lambda: pref(fields), n=3)
        print(f"  prefilter {t_pref*1e3:8.2f} ms "
              f"(probe+compact over {sim.pair_capacity} cand)", flush=True)

    if sim.walls:
        @jax.jit
        def wallf(st, ng):
            f = jnp.zeros_like(st.x)
            for w_i, wall in enumerate(sim.walls):
                wf, wt, whist, wpe, n_near = walls_mod.wall_contact(
                    st, shapes, params, wall, ng.wall_hist[:, w_i],
                    wall_cap=sim.wall_capacity, exact=sim.exact_eval,
                )
                f = f + wf
            return f

        t_w = timeit(lambda: wallf(state, neigh))
        print(f"walls       {t_w*1e3:8.2f} ms  ({len(sim.walls)} walls)",
              flush=True)

    integ = jax.jit(lambda st: integrate.final_integrate(
        integrate.initial_integrate(st, shapes, params), shapes, params).x)
    t_i = timeit(lambda: integ(state))
    print(f"integ       {t_i*1e3:8.2f} ms", flush=True)

    amort = t_reb / max(sim.rebuild_every, 1)
    print(f"# step budget: forces {t_full*1e3:.1f} + rebuild/R "
          f"{amort*1e3:.1f} + walls+integ (in forces path? no) "
          f"-> measured step {t_step*1e3:.1f} ms "
          f"-> {n / t_step:,.0f} particle-steps/s", flush=True)


if __name__ == "__main__":
    main()
