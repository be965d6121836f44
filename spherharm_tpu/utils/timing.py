"""Per-section timing breakdown — the reference Timer's 5-bucket table.

SURVEY.md section 5.1: LAMMPS accumulates wall time per section (Pair,
Neigh, Comm, Modify, Output) and prints an "MPI task timing breakdown";
keeping the same buckets makes numbers comparable. Inside one fused jit
step the sections aren't separable, so this harness times dedicated
calls of each stage (block_until_ready-bounded) on the live state —
an accurate attribution of where a step's time goes, measured outside
the fused loop.

Also exposes ``trace`` — a thin wrapper over jax.profiler for deep dives.
"""

from __future__ import annotations

import contextlib
import time

import jax


def _timeit(fn, repeats=3):
    fn()  # warm-up / compile
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / repeats


def breakdown(sim, state, neigh, ghosts=None, repeats: int = 3) -> dict:
    """Time each pipeline section. Returns {section: seconds-per-call}.

    Sections mirror the reference's table:
      Pair    - contact force evaluation (the SH hot loop)
      Neigh   - full neighbor rebuild (bin + list + history remap)
      Comm    - forward halo exchange (sharded runs only)
      Modify  - integration (initial+final half-steps, deformation)
      Output  - thermo reduction
    """
    from spherharm_tpu.ops import integrate

    out = {}
    sharded = ghosts is not None
    if sharded:
        mesh, specs = sim.mesh, sim._specs

        def smap(body, *args):
            return jax.jit(
                jax.shard_map(
                    body, mesh=mesh, in_specs=specs(args),
                    out_specs=specs(args), check_vma=False,
                )
            )(*args)

        out["Pair"] = _timeit(
            lambda: smap(
                lambda s, n, g: (sim._forces(s, n, g)[0], n, g),
                state, neigh, ghosts,
            ), repeats,
        )
        out["Neigh"] = _timeit(
            lambda: smap(
                lambda s, n, g: sim._rebuild(s, n, g), state, neigh, ghosts
            ), repeats,
        )
        out["Comm"] = _timeit(
            lambda: smap(
                lambda s, n, g: sim._forward_comm(s, n, g),
                state, neigh, ghosts,
            ), repeats,
        )
        out["Modify"] = _timeit(
            lambda: smap(
                lambda s, n, g: (
                    integrate.final_integrate(
                        integrate.initial_integrate(s, sim.shapes, sim.params),
                        sim.shapes, sim.params,
                    ), n, g,
                ),
                state, neigh, ghosts,
            ), repeats,
        )
        out["Output"] = _timeit(
            lambda: sim.thermo(state, neigh, ghosts)["etot"], repeats
        )
    else:
        out["Pair"] = _timeit(
            lambda: sim.compute_forces(state, neigh)[0].f, repeats
        )
        out["Neigh"] = _timeit(
            lambda: _rebuild_once(sim, state, neigh)[0].x, repeats
        )
        out["Comm"] = 0.0
        out["Modify"] = _timeit(
            lambda: integrate.final_integrate(
                integrate.initial_integrate(state, sim.shapes, sim.params),
                sim.shapes, sim.params,
            ).x,
            repeats,
        )
        out["Output"] = _timeit(
            lambda: sim.thermo(state, neigh)["etot"], repeats
        )
    return out


@jax.jit
def _noop(x):
    return x


def _rebuild_once(sim, state, neigh):
    import functools

    @functools.partial(jax.jit, static_argnames=())
    def f(state, neigh):
        return sim._rebuild(state, neigh)

    return f(state, neigh)


def print_breakdown(sections: dict, total_step_s: float | None = None):
    """Render the LAMMPS-style timing table."""
    tot = sum(sections.values())
    print(f"{'Section':<10}{'time/call (s)':>16}{'% of sections':>16}")
    for k, v in sections.items():
        pct = 100.0 * v / tot if tot else 0.0
        print(f"{k:<10}{v:>16.5f}{pct:>15.1f}%")
    if total_step_s is not None:
        print(f"{'Step':<10}{total_step_s:>16.5f}  (fused jit loop)")


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace context (open with TensorBoard / xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
