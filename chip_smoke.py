"""Smoke test of the DEM engine on an NVIDIA GPU.

Runs the main path once through the entry points a user calls, at the
flagship deployment's full width (config 4: 100k polydisperse Lmax=8
particles in a rotating drum), and checks what comes out. Phases:

  device  JAX must see a GPU; prints the card's name and power limit.
  parity  The contact law as XLA compiles it for the card
          (contact.pair_contact_rows, exact recurrence, f32) against the
          same law compiled for the host CPU, on >= 65,536 live pairs of
          the 100k drum squeezed into contact, in both elastic modes;
          then the rebuild-time prefilter probe must bound every
          contact's fine-grid depth from above, on the card.
  drum    The 100k drum through Simulation.run with the bench settings
          (conservative, rebuild_every=20, pair_capacity=5n,
          stage2_capacity=3n with the prefilter, walls on): 3 x 60
          steps; fails on overflow, skin violations or non-finite
          energy. Prints particle-steps/s, set-up and compile time and
          peak device memory.
  walls   The three walls' share of the drum step (the wall narrow
          phase timed alone against the steady step).
  deck    examples/two_body.in through the deck runner.

``--four`` runs only the sharded path (config 5) on four GPUs and what
it is compared with: a triaxial_cell slab decomposition and a 2x2 brick,
each against the same state on one device through Simulation.

Usage: python chip_smoke.py [--four] [--n N] [--seed S] [--phases ...]
Exits non-zero on any failure; the last line of a passing run is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# The drum's step peaks near 61 GB on an 80 GB card, close to the three
# quarters a JAX process reserves by default; this process is the card's
# only user.
os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.9")

PHASES = ("device", "parity", "drum", "walls", "deck")


def log(msg: str) -> None:
    print(f"# {msg}", flush=True)


def device_check(count: int):
    """Fail unless JAX sees at least ``count`` GPUs; print the card."""
    from spherharm_tpu.utils import device

    try:
        devs, card = device.require_gpu(count)
    except RuntimeError as e:
        raise SystemExit(f"chip_smoke: {e}")
    log(f"devices: {devs[0].platform} {devs[0].device_kind} x{len(devs)}")
    log(f"card: {card}")
    return devs, card


def peak_bytes(dev) -> int:
    """Peak device memory in use so far (-1 where the backend keeps no
    statistics)."""
    return int((dev.memory_stats() or {}).get("peak_bytes_in_use", -1))


def timed(fn, *args):
    """(result, seconds) of fn(*args), waiting for the device."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


# -- parity ----------------------------------------------------------------

def dense_pairs(sim, state, n_pairs: int, seed: int):
    """``n_pairs`` live nearest-neighbour pairs of the drum's lattice,
    squeezed so that about a third of them overlap (the drum starts as a
    loose lattice with next to no contacts)."""
    import jax.numpy as jnp

    from spherharm_tpu.ops import contact, neighbor

    act = np.asarray(state.active)
    x = np.asarray(state.x, np.float64)
    c = x[act].mean(axis=0)
    # Lattice pitch of the drum's initial packing (its rows run along y).
    pitch = float(np.min(np.linalg.norm(x[1:64] - x[0], axis=1)))
    rc = float(np.mean(np.asarray(sim.shapes.rchar)))
    xs = c + (x - c) * (2.05 * rc / pitch)
    state_c = state.replace(x=jnp.asarray(xs, state.x.dtype))
    cut = 1.5 * 2.05 * rc
    grid = neighbor.CellGrid(np.asarray(state.box_lo),
                             np.asarray(state.box_hi), cut)
    idx, mask, _, _ = neighbor.cell_list_neighbors(
        state_c.x, state_c.active, state_c.box_lo, state_c.box_hi, cut,
        grid.dims, 16, 16, sim.periodic)
    hist0 = jnp.zeros(idx.shape + (6,), state.x.dtype)
    fields, n_live = contact.build_pair_list(
        state_c, sim.shapes, sim.params, idx, mask, hist0, state_c.active,
        4 * n_pairs, sim.periodic)
    if int(n_live) < n_pairs:
        raise AssertionError(f"only {int(n_live)} live pairs < {n_pairs}")
    rng = np.random.default_rng(seed)
    hist = jnp.asarray(rng.normal(size=(n_pairs, 6)) * 1e-4, jnp.float32)
    return (state_c, fields["pair_i"][:n_pairs], fields["pair_j"][:n_pairs],
            fields["pair_valid"][:n_pairs], hist)


def contact_law(sim, state, pi, pj, mask, hist, conservative: bool,
                device, chunk: int = 16384):
    """pair_contact_rows (exact recurrence, f32, every matrix product at
    the highest precision) on ``device``, in chunks. Returns numpy
    (force, torque_i, torque_j, springs, pe, in_contact)."""
    import jax

    from spherharm_tpu.ops import contact

    put = lambda a: jax.device_put(a, device)
    shapes, params, state = put(sim.shapes), put(sim.params), put(state)
    rows = contact.particle_rows(state, shapes)
    outs = []
    with jax.default_matmul_precision("highest"):
        for s in range(0, pi.shape[0], chunk):
            i, j = put(pi[s:s + chunk]), put(pj[s:s + chunk])
            out = contact.pair_contact_rows(
                rows[i], rows[j], state.shtype[i], state.shtype[j],
                put(hist[s:s + chunk]), put(mask[s:s + chunk]),
                state.box_lo, state.box_hi, shapes, params,
                exact=True, periodic=sim.periodic,
                conservative=conservative)
            outs.append([np.asarray(a) for a in out[:6]])
    return [np.concatenate(c) for c in zip(*outs)]


# Conservative mode differentiates a node-sampled PE. Where a cap node
# crosses the other surface the gradient of the depth moment S1 jumps, so
# an ulp-level change of a position moves that pair's force by up to
# ~1.5e-3 of the largest force (on the CPU alone, nudging x by one ulp).
# The PE itself is continuous. So in conservative mode the force and
# torques of at most one contact in a thousand may differ by up to the
# geometric tolerance; all other values hold 1e-4.
KINK_TOL = 2e-3
KINK_SHARE = 1e-3


def check_parity(sim, state, pi, pj, mask, hist, conservative: bool, dev):
    """Card vs host CPU at the tolerances of the contact-law contract:
    1e-4 of the largest value in conservative mode (see KINK_TOL), 2e-3
    geometric."""
    import jax

    gpu, t_gpu = timed(lambda: contact_law(sim, state, pi, pj, mask, hist,
                                           conservative, dev))
    cpu, t_cpu = timed(lambda: contact_law(sim, state, pi, pj, mask, hist,
                                           conservative,
                                           jax.devices("cpu")[0]))
    f, _, _, _, pe, inc = cpu
    inc_g = gpu[5]
    pe_max = max(float(pe.max()), 1e-30)
    # Contact sets agree except at grazing depth (pe < 1e-6 of the max).
    odd = (inc_g != inc) & (np.maximum(pe, gpu[4]) > 1e-6 * pe_max)
    tol = 1e-4 if conservative else 2e-3
    fmax = float(np.abs(f).max())
    # Per pair: the largest error of force, torque_i and torque_j.
    per_pair = np.max([np.abs(gpu[k] - cpu[k]).max(axis=1)
                       for k in range(3)], axis=0) / fmax
    errs = {name: float(np.abs(gpu[k] - cpu[k]).max()) / fmax
            for k, name in enumerate(("f", "tau_i", "tau_j"))}
    errs["pe"] = float(np.abs(gpu[4] - pe).max()) / pe_max
    n_over = int(np.sum(per_pair > tol))
    allowed = int(KINK_SHARE * inc.sum()) if conservative else 0
    mode = "conservative" if conservative else "geometric"
    log(f"parity {mode} (card vs host cpu, f32): pairs={pi.shape[0]} "
        f"live={int(np.sum(mask))} contacts={int(inc.sum())} "
        f"set_mismatch={int(np.sum(inc_g != inc))} (non-grazing "
        f"{int(odd.sum())}) max|err|/max: "
        + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + f"; pairs beyond {tol:g}: {n_over} (allowed {allowed}) "
        f"(card {t_gpu:.1f}s, cpu {t_cpu:.1f}s, compiles included)")
    if int(inc.sum()) < pi.shape[0] // 10:
        raise AssertionError(f"too few contacts for parity: {int(inc.sum())}")
    if odd.any():
        raise AssertionError(f"{int(odd.sum())} non-grazing contact flags "
                             "differ between card and cpu")
    if not errs["pe"] <= tol:
        raise AssertionError(f"{mode} pe parity beyond {tol:g}: {errs}")
    if n_over > allowed or not per_pair.max() <= max(tol, KINK_TOL):
        raise AssertionError(
            f"{mode} force/torque parity: {n_over} pairs beyond {tol:g} "
            f"(allowed {allowed}), largest {per_pair.max():.3e}")
    return inc


def check_probe_bound(sim, state, pi, pj, mask, inc):
    """The jnp prefilter probe (coarse grid) plus its slack must bound
    the fine-grid node depth of every pair in contact."""
    from spherharm_tpu.ops import contact

    rows = contact.particle_rows(state, sim.shapes)
    d = contact.minimum_image(rows[pj][:, 0:3] - rows[pi][:, 0:3],
                              state.box_lo, state.box_hi, sim.periodic)
    rc = np.minimum(np.asarray(rows[pi][:, contact._RRC]),
                    np.asarray(rows[pj][:, contact._RRC]))
    bound = np.asarray(contact.probe_pairs(
        state, sim.shapes, pi, pj, mask, d, rows)) + contact.PROBE_SLACK * rc
    c = 16384
    depth = np.concatenate([
        np.asarray(contact.max_node_depth(
            rows[pi[s:s + c]], rows[pj[s:s + c]], state.shtype[pi[s:s + c]],
            state.shtype[pj[s:s + c]], d[s:s + c], sim.shapes))
        for s in range(0, pi.shape[0], c)])
    short = inc & (bound < depth)
    log(f"probe bound: contacts={int(inc.sum())} "
        f"min(bound - depth)={float(np.min((bound - depth)[inc])):.4g} "
        f"violations={int(short.sum())}")
    if short.any():
        raise AssertionError(f"probe under-bounds {int(short.sum())} "
                             "contacts")


def phase_parity(sim, state, dev, seed: int, n_pairs: int):
    state_c, pi, pj, mask, hist = dense_pairs(sim, state, n_pairs, seed)
    for cons in (False, True):
        inc = check_parity(sim, state_c, pi, pj, mask, hist, cons, dev)
    check_probe_bound(sim, state_c, pi, pj, mask, inc)


# -- drum ------------------------------------------------------------------

def drum_setup(n: int, seed: int):
    import jax

    from spherharm_tpu.models import scenarios

    t0 = time.perf_counter()
    sim, state, neigh = scenarios.rotating_drum(
        n=n, lmax=8, seed=seed, k_max=24, pair_capacity=5 * n,
        stage2_capacity=3 * n, rebuild_every=20, conservative=True)
    jax.block_until_ready(state.x)
    return sim, state, neigh, time.perf_counter() - t0


def check_run(sim, state, neigh, what: str):
    overflow = int(neigh.overflow)
    viol = int(neigh.skin_violations)
    etot = float(sim.thermo(state, neigh)["etot"])
    if overflow or viol or not np.isfinite(etot):
        raise AssertionError(f"{what}: overflow={overflow} "
                             f"skin_violations={viol} etot={etot}")
    return etot


def phase_drum(sim, state, neigh, setup_s, card, dev, block=60, blocks=3):
    """Returns the final (state, neigh) and the steady seconds/step."""
    n = int(state.n_active)
    times = []
    for _ in range(blocks):
        (state, neigh), dt = timed(sim.run, state, neigh, block)
        times.append(dt)
    etot = check_run(sim, state, neigh, "drum")
    steady = min(times[1:])
    log(f"drum n={n} lmax=8 conservative: {blocks}x{block} steps, block "
        "times " + ", ".join(f"{t:.3f}s" for t in times)
        + f"; etot={etot:.6g}; overflow=0 skin_violations=0")
    log(f"drum particle-steps/s={n * block / steady:.1f} "
        f"({1e3 * steady / block:.3f} ms/step) ({card})")
    log(f"drum setup_s={setup_s:.2f} compile_s={times[0] - steady:.2f} "
        f"(first block minus a steady block) ({card})")
    log(f"drum peak_bytes_in_use={peak_bytes(dev)} ({card})")
    return state, neigh, steady / block


def phase_walls(sim, state, neigh, step_s, card, reps=20):
    """Wall narrow phase (all walls, as compute_forces runs it) timed
    alone on the drum state, as a share of the steady step."""
    import jax
    import jax.numpy as jnp

    from spherharm_tpu.ops import walls as walls_mod

    @jax.jit
    def walls_only(st, ng):
        total = jnp.zeros(())
        for w_i, wall in enumerate(sim.walls):
            wf, wt, *_ = walls_mod.wall_contact(
                st, sim.shapes, sim.params, wall, ng.wall_hist[:, w_i],
                wall_cap=sim.wall_capacity, exact=sim.exact_eval)
            total = total + jnp.sum(wf) + jnp.sum(wt)
        return total

    timed(walls_only, state, neigh)
    _, dt = timed(lambda: [walls_only(state, neigh) for _ in range(reps)])
    w = dt / reps
    log(f"walls: {len(sim.walls)} walls (wall_capacity="
        f"{sim.wall_capacity}) {1e3 * w:.3f} ms alone = "
        f"{100 * w / step_s:.1f}% of the {1e3 * step_s:.3f} ms step "
        f"({card})")


# -- deck ------------------------------------------------------------------

def phase_deck():
    from spherharm_tpu.io.deck import DeckRunner

    r = DeckRunner().run_file("examples/two_body.in")
    t = r.sim.thermo(r.state, r.neigh)
    etot = float(t["etot"])
    if not np.isfinite(etot) or int(t["n"]) != 2:
        raise AssertionError(f"deck: n={int(t['n'])} etot={etot}")
    log(f"deck examples/two_body.in: {r.total_steps} steps, etot={etot:.6g}")


# -- four cards --------------------------------------------------------------

def phase_four(devs, n_per: int, steps: int, seed: int):
    """Config 5 on four GPUs: a slab decomposition and a 2x2 brick,
    each against the same state on one device through Simulation.
    Particle count exact; etot to 1e-4 and the stress tensor to 1e-3 of
    its largest entry (f32 sums in another order, over a few steps)."""
    import jax
    from jax.sharding import Mesh

    from spherharm_tpu.models import scenarios

    n = 4 * n_per
    t0 = time.perf_counter()
    # Chunked narrow phase: the one-device list holds 12n pair slots.
    ref_sim, ref_s, ref_n = scenarios.triaxial_cell(n=n, seed=seed,
                                                    pair_chunk=65536)
    jax.block_until_ready(ref_s.x)
    t1 = time.perf_counter()
    ref_s, ref_n = ref_sim.run(ref_s, ref_n, steps)
    jax.block_until_ready(ref_s.x)
    check_run(ref_sim, ref_s, ref_n, "four: one device")
    ref = ref_sim.thermo(ref_s, ref_n)
    log(f"four: triaxial n={n} lmax={ref_sim.shapes.lmax} one device: "
        f"setup {t1 - t0:.1f}s, {steps} steps {time.perf_counter() - t1:.2f}s"
        " (incl. compile)")
    del ref_s, ref_n

    out = {}
    for name, shape, axes in (("slab", (4,), ("x",)),
                              ("brick", (2, 2), ("x", "y"))):
        mesh = Mesh(np.array(devs[:4]).reshape(shape), axes)
        t0 = time.perf_counter()
        sim, st, ng, gh = scenarios.triaxial_cell(
            n=n, seed=seed, sharded=True, mesh=mesh)
        jax.block_until_ready(st.x)
        t1 = time.perf_counter()
        st, ng, gh = sim.run(st, ng, gh, steps)
        jax.block_until_ready(st.x)
        out[name] = sim.thermo(st, ng, gh)
        used = sorted(d.id for d in st.x.sharding.device_set)
        log(f"four: {name} {'x'.join(map(str, shape))} on devices {used}: "
            f"setup {t1 - t0:.1f}s, {steps} steps "
            f"{time.perf_counter() - t1:.2f}s (incl. compile)")
        if len(used) != 4:
            raise AssertionError(f"four: {name} state on devices {used}")
        del sim, st, ng, gh

    s_ref = np.asarray(ref["stress"], np.float64)
    scale = float(np.abs(s_ref).max())
    for name, t in out.items():
        n_got = int(t["n"])
        e_rel = abs(float(t["etot"]) - float(ref["etot"])) / abs(
            float(ref["etot"]))
        s_rel = float(np.abs(np.asarray(t["stress"]) - s_ref).max()) / scale
        log(f"four: {name} n={n_got} etot={float(t['etot']):.8g} "
            f"(one device {float(ref['etot']):.8g}, rel {e_rel:.2e}) "
            f"max|dstress|/max={s_rel:.2e} "
            f"neigh_overflow={int(t['neigh_overflow'])}")
        if n_got != n or not e_rel <= 1e-4 or not s_rel <= 1e-3:
            raise AssertionError(f"four: {name} disagrees with one device")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on four GPUs")
    ap.add_argument("--n", type=int, default=100_000,
                    help="drum particles (default 100000)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--parity-pairs", type=int, default=65536)
    ap.add_argument("--four-n-per-card", type=int, default=50_000)
    ap.add_argument("--four-steps", type=int, default=20)
    args = ap.parse_args(argv)

    devs, card = device_check(4 if args.four else 1)
    if args.four:
        phase_four(devs, args.four_n_per_card, args.four_steps, args.seed)
    else:
        phases = set(args.phases.split(","))
        if phases - set(PHASES):
            raise SystemExit(f"unknown phases {phases - set(PHASES)}")
        if phases & {"parity", "drum", "walls"}:
            sim, state, neigh, setup_s = drum_setup(args.n, args.seed)
            log(f"drum setup {setup_s:.1f}s (n={args.n}, grid "
                f"{sim.grid.dims}, pair_capacity={sim.pair_capacity})")
            if "parity" in phases:
                phase_parity(sim, state, devs[0], args.seed,
                             args.parity_pairs)
            if phases & {"drum", "walls"}:
                state, neigh, step_s = phase_drum(sim, state, neigh, setup_s,
                                                  card, devs[0])
            if "walls" in phases:
                phase_walls(sim, state, neigh, step_s, card)
        if "deck" in phases:
            phase_deck()
    from spherharm_tpu.utils import device

    print(json.dumps({"ok": True, "device": device.describe(devs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
