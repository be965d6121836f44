"""Numerical sanitizers — the reference's sanitizer/CI role, JAX-style.

SURVEY.md section 5.2: the reference relies on ASan/UBSan builds; the
pure-functional JAX design has no shared-memory races, so the
equivalents are (a) NaN/Inf detection, (b) capacity-overflow audits of
the fixed-size tensors, (c) determinism checks (same seed => identical
trajectory).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def check_finite(state, where: str = "") -> None:
    """Raise if any dynamic field holds NaN/Inf (host-side audit)."""
    bad = {}
    for f in ("x", "v", "q", "angmom", "f", "tau"):
        arr = np.asarray(getattr(state, f))
        act = np.asarray(state.active)
        vals = arr[act] if arr.ndim > 1 else arr[act]
        if not np.isfinite(vals).all():
            bad[f] = int((~np.isfinite(vals)).sum())
    if bad:
        raise FloatingPointError(f"non-finite state {where}: {bad}")


def audit_capacities(sim, neigh) -> dict:
    """Report fixed-capacity state (neighbor K, pair slots, cells).

    The overflow channel is per-source gated: each count is folded in
    only when it exceeds its OWN capacity, so the channel is 0 in a
    healthy run and carries the exceeding count (or a 1<<20 / 1<<21
    sentinel) when any capacity was breached (SURVEY.md 7.1: 'overflow
    is detected and triggers a re-allocation with larger K').
    """
    ovf = int(neigh.overflow)
    report = {
        "overflow_channel": (ovf, 0),
        "k_max": sim.k_max,
    }
    if getattr(sim, "pair_capacity", 0):
        report["pair_capacity"] = sim.pair_capacity
    return report


def assert_no_overflow(sim, neigh) -> None:
    """Raise if ANY fixed capacity was exceeded (gated channel != 0)."""
    ovf = int(neigh.overflow)
    if ovf != 0:
        raise RuntimeError(
            f"capacity overflow (gated channel = {ovf}): physics was "
            "truncated — raise k_max / cell_cap / pair_capacity / "
            "stage2_capacity / halo or migrate caps"
        )


def determinism_check(run_fn, make_inputs, n: int = 2) -> bool:
    """Same inputs => bitwise-identical outputs (XLA determinism audit)."""
    outs = []
    for _ in range(n):
        out = run_fn(*make_inputs())
        outs.append(jax.tree.map(lambda a: np.asarray(a), out))
    ref = outs[0]
    for other in outs[1:]:
        ok = jax.tree.all(
            jax.tree.map(lambda a, b: np.array_equal(a, b), ref, other)
        )
        if not ok:
            return False
    return True


def enable_nan_debugging() -> None:
    """Turn on jax debug_nans (traps the first NaN-producing op)."""
    jax.config.update("jax_debug_nans", True)
