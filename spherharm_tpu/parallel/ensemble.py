"""Replica ensembles: vmapped independent simulations (parameter sweeps).

The reference's multi-partition ``Universe`` / replica runs (SURVEY.md
section 2 B.6: "Data parallel ... closest: replica runs (temper,
multi-partition Universe)") map onto ``jax.vmap`` over the whole
simulation step — the trivial form of data parallelism. One compiled
program advances R replicas that differ in state and/or physics
parameters (e.g. a friction-coefficient sweep), batched on one chip or
sharded over a mesh axis.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def replicate(tree, n: int):
    """Tile a pytree along a new leading replica axis."""
    return jax.tree.map(
        lambda a: jnp.broadcast_to(a[None], (n,) + a.shape), tree
    )


# SimParams material scalars mirrored into the per-type-pair table
# (core.state.pair_material reads the table, not the scalars).
_MAT_SLOT = {"kn": 0, "kt": 1, "gamma_n": 2, "gamma_t": 3, "mu": 4,
             "k_roll": 5, "gamma_roll": 6, "mu_roll": 7}


def with_param_sweep(params, **overrides):
    """Replica-stack params with per-replica values for chosen fields.

    Example: ``with_param_sweep(params, mu=jnp.linspace(0.1, 0.9, 8))``
    returns params with every leaf tiled to [R, ...] and ``mu`` varying.

    Sweeping a material scalar (kn, mu, ...) also overrides that slot of
    the WHOLE pair_tab — material sweeps are global; per-type-pair
    tables and sweeps don't compose (sweep pair_tab directly for that).
    """
    lengths = {k: len(v) for k, v in overrides.items()}
    n = next(iter(lengths.values()))
    assert all(v == n for v in lengths.values()), "sweep lengths differ"
    stacked = replicate(params, n)
    for k, v in overrides.items():
        stacked = stacked.replace(**{k: jnp.asarray(v, getattr(params, k).dtype)})
        if k in _MAT_SLOT:
            pt = stacked.pair_tab  # [R, T, T, 8]
            vv = jnp.asarray(v, pt.dtype).reshape(-1, 1, 1)
            stacked = stacked.replace(
                pair_tab=pt.at[..., _MAT_SLOT[k]].set(vv)
            )
    return stacked


@partial(jax.jit, static_argnames=("sim", "n_steps"))
def run_replicas(sim, states, neighs, params_stack, n_steps: int):
    """Advance R independent replicas of a Simulation in one program.

    states/neighs: pytrees with a leading replica axis (from ``replicate``
    or stacked initial conditions); params_stack: per-replica SimParams.
    """

    def one(state, neigh, params):
        sim_p = _rebind(sim, params)
        return sim_p.run_inline(state, neigh, n_steps)

    return jax.vmap(one)(states, neighs, params_stack)


def _rebind(sim, params):
    """A Simulation view with replica-local params (same static config).

    Note: under vmap, lax.cond lowers to both-branches select, so the
    displacement-triggered rebuild executes every step inside replica
    sweeps — correct, just not skipped. Acceptable for sweep workloads.
    """
    import copy

    s = copy.copy(sim)
    s.params = params
    return s
