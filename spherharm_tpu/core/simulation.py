"""The timestep driver: LAMMPS's Verlet::run as one jitted lax.scan.

Array-program collapse of the reference's Update/Integrate/Modify/Neighbor
orchestration (SURVEY.md section 3.2). Per step:

  initial_integrate   (half kick + drift + quaternion Richardson update)
  maybe-rebuild       (lax.cond on the skin-displacement trigger: wrap
                       PBC, re-bin cells, rebuild [N,K] list, remap
                       contact history — all inside jit, static shapes)
  force eval          (SH pair contact + walls + gravity)
  final_integrate     (second half kick)

The whole step is one pure function ``(state, neigh) -> (state, neigh)``;
``run`` scans it. No data-dependent Python control flow (everything is
lax.cond / masked tensor ops), so XLA compiles the full loop once.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from spherharm_tpu.core.state import (
    NeighborState,
    SimParams,
    Shapes,
    State,
    empty_neighbors,
)
from spherharm_tpu.ops import contact, integrate, neighbor, walls as walls_mod


class Simulation:
    """Binds static configuration (topology, capacities, wall kinds).

    Everything dynamic rides in (State, NeighborState, SimParams, Shapes)
    pytrees; a Simulation instance is hashable-by-identity and used as a
    static jit argument, so its plain-Python config fixes the compiled
    program.
    """

    def __init__(
        self,
        shapes: Shapes,
        params: SimParams,
        *,
        periodic=(False, False, False),
        neighbor_mode: str = "cell",  # "cell" | "allpairs" | "static"
        k_max: int = 32,
        cell_cap: int = 8,
        grid: neighbor.CellGrid | None = None,
        walls: tuple = (),
        exact_eval: bool = True,
        pair_chunk: int = 0,
        pair_capacity: int = 0,
        rebuild_chunk: int | None = None,
        press_control: bool = False,
        rebuild_every: int = 0,
        wall_capacity: int = 0,
        stage2_capacity: int = 0,
        triclinic: bool = False,
        conservative: bool = True,
        gravity_pe_origin=(0.0, 0.0, 0.0),
        group_fixes: tuple = (),
        group_tab=None,
    ):
        self.shapes = shapes
        self.params = params
        self.periodic = tuple(bool(p) for p in periodic)
        self.neighbor_mode = neighbor_mode
        self.k_max = int(k_max)
        self.cell_cap = int(cell_cap)
        self.grid = grid
        self.walls = tuple(walls)
        # Radius evaluation: the ALP/Ylm recurrence (exact_eval=True,
        # the method the contract names) or the bilinear interp table.
        self.exact_eval = bool(exact_eval)
        self.pair_chunk = int(pair_chunk)
        self.pair_capacity = int(pair_capacity)
        # Chunking of the rebuild-time transients (stencil/top_k rows in
        # cell_list_neighbors, the prefilter probe over the candidate
        # list). Chunking exists ONLY to bound transient device memory
        # at large N (n~1M) — below that it merely serializes the
        # rebuild into sequential launches. Auto (None): unchunked up to
        # pair_capacity ~1.5M (n~300k at the 5n candidate sizing),
        # 262144-row chunks beyond. 0 forces unchunked.
        if rebuild_chunk is None:
            rebuild_chunk = 0 if int(pair_capacity) <= 1_500_000 else 262144
        self.rebuild_chunk = int(rebuild_chunk)
        # Rebuild-time narrow-phase prefilter (contact.prefilter_pair_list):
        # with a stage-2 capacity, the candidate pair list (pair_capacity
        # slots, transient) is probed ONCE per rebuild and compacted to
        # stage2_capacity near-contact pairs — the persistent per-step
        # list. The per-step hot path then has no probe, no candidate
        # pack, and smaller segment-sums. Correctness rests on the
        # rotation-aware motion-budget trigger (neighbor.approach_ratio).
        self.prefilter = int(stage2_capacity) > 0 and int(pair_capacity) > 0
        self.press_control = bool(press_control)
        self.rebuild_every = int(rebuild_every)
        self.wall_capacity = int(wall_capacity)
        self.stage2_capacity = int(stage2_capacity)
        # Triclinic mode: thread state.tilt into every geometry op. For
        # tilted cells size the CellGrid with a tilt-inflated cutoff
        # (binning runs in the unsheared frame; see ops/contact.py
        # unshear_coords).
        self.triclinic = bool(triclinic)
        # Conservative mode (the DEFAULT): elastic force/torques from
        # the exact autodiff gradient of the sampled PE. Fixes the
        # secular NVE energy loss of the geometric assembly at the cost
        # of a pe-vjp per pair. The geometric assembly
        # (conservative=False) remains as a documented opt-out for
        # damped/driven runs where secular NVE drift is irrelevant.
        # See ops.contact.pair_elastic_grad.
        self.conservative = bool(conservative)
        self.gravity_pe_origin = jnp.asarray(gravity_pe_origin, jnp.float32)
        # Runtime per-group fixes (LAMMPS `fix <id> <group> freeze` /
        # `fix ... setforce fx fy fz` with NULL components). Group
        # membership is keyed by TAG through a static lookup table
        # (group_tab[tag] = group bitmask), so it needs no new per-atom
        # comm/restart field — tags already ride migration and
        # checkpoints. group_fixes entries are hashable tuples
        # ("freeze", bit, (0,0,0), (0,0,0)) or
        # ("setforce", bit, values3, keep3) where keep marks NULL
        # components (force left unchanged).
        self.group_fixes = tuple(group_fixes)
        if self.group_fixes and group_tab is None:
            raise ValueError("group_fixes requires group_tab")
        self.group_tab = (
            None if group_tab is None
            else jnp.asarray(group_tab, jnp.int32)
        )
        if neighbor_mode == "cell" and grid is None:
            raise ValueError("neighbor_mode='cell' requires a CellGrid")

    # -- neighbor handling ------------------------------------------------

    @property
    def pair_list_cap(self) -> int:
        """Persistent pair-list capacity: the prefiltered (stage-2) cap
        when the rebuild-time prefilter is on, else the candidate cap."""
        return self.stage2_capacity if self.prefilter else self.pair_capacity

    @property
    def _window_steps(self) -> int:
        """Expected steps between rebuilds: the motion-budget horizon of
        the prefilter (static cadence: exactly rebuild_every; adaptive
        trigger: an estimate — budgets are floored/capped, and the
        per-step approach_ratio check keeps correctness regardless)."""
        return self.rebuild_every if self.rebuild_every > 0 else 16

    def _tilt(self, state: State):
        return state.tilt if self.triclinic else None

    def _stale(self, state: State, neigh: NeighborState):
        """Rebuild trigger: True when the neighbor structures may no
        longer be complete. Prefiltered pair list: any particle's
        surface motion exceeded its recorded motion budget
        (ops.neighbor.approach_ratio; the budget's skin/2 cap keeps the
        candidate list's own Verlet guarantee). Plain candidate list:
        max displacement beyond skin/2."""
        if self.prefilter:
            gmax_s = self.shapes.gmax[state.shtype] * state.scale
            ratio = neighbor.approach_ratio(
                state.x, neigh.x_build, state.q, neigh.q_build, gmax_s,
                neigh.budget, state.active,
                state.box_lo, state.box_hi, self.periodic,
                tilt=self._tilt(state),
            )
            return ratio > 1.0
        disp2 = neighbor.max_displacement2(
            state.x, neigh.x_build, state.active,
            state.box_lo, state.box_hi, self.periodic,
            tilt=self._tilt(state),
        )
        return disp2 > (0.5 * self.params.skin) ** 2

    def _build_list(self, state: State):
        cutoff = self.params.cutoff + self.params.skin
        # The overflow channel is PER-SOURCE gated: a count contributes
        # only when it exceeds its OWN capacity, so any nonzero overflow
        # means physics was truncated somewhere (no source can hide
        # below another source's larger cap).
        if self.neighbor_mode in ("allpairs", "static"):
            idx, mask, count = neighbor.allpairs_neighbors(
                state.x, state.active, state.box_lo, state.box_hi,
                cutoff, self.k_max, self.periodic, tilt=self._tilt(state),
            )
            mx = jnp.max(count)
            return idx, mask, jnp.where(mx > self.k_max, mx, 0)
        idx, mask, count, cell_ovf = neighbor.cell_list_neighbors(
            state.x, state.active, state.box_lo, state.box_hi, cutoff,
            self.grid.dims, self.cell_cap, self.k_max, self.periodic,
            tilt=self._tilt(state), row_chunk=self.rebuild_chunk,
        )
        mx = jnp.max(count)
        return idx, mask, jnp.maximum(
            jnp.where(mx > self.k_max, mx, 0),
            jnp.where(cell_ovf > self.cell_cap, cell_ovf, 0),
        )

    def _rebuild(self, state: State, neigh: NeighborState):
        x, image = neighbor.wrap_positions(
            state.x, state.image, state.box_lo, state.box_hi, self.periodic,
            tilt=self._tilt(state),
        )
        state = state.replace(x=x, image=image)
        if self.pair_capacity > 0:
            # Live springs ride in pair space between rebuilds; fold them
            # back into the tag-keyed [N, K] layout before remapping.
            neigh = neigh.replace(hist=contact.pair_hist_to_dense(neigh))
        idx, mask, overflow = self._build_list(state)
        neigh_tag = jnp.where(mask, state.tag[idx], 0)
        row_ok = neigh.row_tag == state.tag  # single-device: slots stable
        hist = neighbor.remap_history(
            neigh_tag, mask, neigh.neigh_tag, neigh.mask, neigh.hist, row_ok
        )
        neigh = neigh.replace(
            idx=idx, mask=mask, hist=hist, neigh_tag=neigh_tag,
            row_tag=state.tag, x_build=state.x, q_build=state.q,
            overflow=jnp.maximum(neigh.overflow, overflow),
        )
        if self.pair_capacity > 0:
            pair_fields, n_pairs = contact.build_pair_list(
                state, self.shapes, self.params, idx, mask, hist,
                state.active, self.pair_capacity, self.periodic,
                tilt=self._tilt(state),
            )
            overflow = jnp.maximum(
                neigh.overflow,
                jnp.where(n_pairs > self.pair_capacity, n_pairs, 0),
            )
            if self.prefilter:
                pair_fields, n_surv, budget = contact.prefilter_pair_list(
                    state, self.shapes, self.params, pair_fields,
                    self.stage2_capacity, self.k_max,
                    window_steps=self._window_steps,
                    periodic=self.periodic,
                    tilt=self._tilt(state),
                    probe_chunk=self.rebuild_chunk,
                )
                overflow = jnp.maximum(
                    overflow,
                    jnp.where(n_surv > self.stage2_capacity, n_surv, 0),
                )
                neigh = neigh.replace(budget=budget)
            neigh = neigh.replace(overflow=overflow, **pair_fields)
        return state, neigh

    def init_neighbors(self, state: State) -> tuple[State, NeighborState]:
        """First build + setup force pass (the Verlet::setup analogue).

        Forces are filled at setup so the first step's initial
        half-kick integrates f(t0) rather than zeros — the reference's
        setup() runs the force computation before stepping, and the
        sharded init does the same (states prepared with deep initial
        overlaps diverge between the two paths otherwise).

        The whole setup pass runs under ONE jit (``_init_jit``): eager
        execution compiled ~300 separate one-op XLA programs.
        """
        return _init_jit(self, state)

    def _maybe_rebuild(self, state: State, neigh: NeighborState):
        if self.neighbor_mode == "static":
            return state, neigh
        need = self._stale(state, neigh)
        return jax.lax.cond(
            need, lambda sn: self._rebuild(*sn), lambda sn: sn, (state, neigh)
        )

    # -- forces -----------------------------------------------------------

    def compute_forces(self, state: State, neigh: NeighborState):
        """Fill f/tau; returns (state, neigh-with-updated-history, aux)."""
        if self.pair_capacity > 0:
            f, tau, pair_hist, pe_pair, virial = (
                contact.contact_force_pairs(
                    state, self.shapes, self.params, neigh,
                    exact=self.exact_eval, periodic=self.periodic,
                    chunk=self.pair_chunk,
                    tilt=self._tilt(state),
                    conservative=self.conservative,
                )
            )
            neigh = neigh.replace(pair_hist=pair_hist)
        else:
            f, tau, hist, pe_pair, virial = contact.contact_force_dense(
                state, self.shapes, self.params, neigh,
                exact=self.exact_eval, periodic=self.periodic,
                chunk=self.pair_chunk, tilt=self._tilt(state),
                conservative=self.conservative,
            )
            neigh = neigh.replace(hist=hist)

        pe_wall = jnp.zeros((), f.dtype)
        wall_hists = []
        for w_i, wall in enumerate(self.walls):
            wf, wt, whist, wpe, n_near = walls_mod.wall_contact(
                state, self.shapes, self.params, wall,
                neigh.wall_hist[:, w_i], wall_cap=self.wall_capacity,
                exact=self.exact_eval,
            )
            f = f + wf
            tau = tau + wt
            pe_wall = pe_wall + jnp.sum(wpe)
            wall_hists.append(whist)
            if self.wall_capacity:
                neigh = neigh.replace(overflow=jnp.maximum(
                    neigh.overflow,
                    jnp.where(n_near > self.wall_capacity, n_near, 0),
                ))
        if wall_hists:
            neigh = neigh.replace(
                wall_hist=jnp.stack(wall_hists, axis=1)
            )

        m = self.shapes.mass_of(state.shtype, state.scale)
        f = f + jnp.where(
            state.active[:, None], m[:, None] * self.params.gravity[None, :], 0.0
        )
        # Runtime group fixes run LAST, after pair/wall/gravity forces —
        # the reference's post_force ordering, where setforce overrides
        # whatever accumulated (Modify hook order, SURVEY.md 3.2).
        if self.group_fixes:
            bits = self.group_tab[
                jnp.clip(state.tag, 0, self.group_tab.shape[0] - 1)
            ]
            for kind, bit, vals, keep in self.group_fixes:
                member = state.active & ((bits & (1 << bit)) != 0)
                mem3 = member[:, None]
                if kind == "freeze":
                    f = jnp.where(mem3, 0.0, f)
                    tau = jnp.where(mem3, 0.0, tau)
                elif kind == "setforce":
                    v = jnp.asarray(vals, f.dtype)
                    kp = jnp.asarray(keep, bool)
                    f = jnp.where(mem3 & ~kp[None, :], v[None, :], f)
                else:
                    raise ValueError(f"unknown group fix {kind!r}")
        state = state.replace(f=f, tau=tau)
        aux = {"pe_pair": pe_pair, "pe_wall": pe_wall, "virial": virial}
        return state, neigh, aux

    # -- stepping ---------------------------------------------------------

    def _step_core(self, state: State, neigh: NeighborState,
                   rebuild: str):
        """One VV step. rebuild: 'check' (lax.cond on the skin trigger),
        'always' (unconditional, static-cadence mode), 'never'."""
        state = integrate.initial_integrate(state, self.shapes, self.params)
        state, x_build, _ = integrate.apply_deformation(
            state, neigh.x_build, self.params, self.periodic
        )
        neigh = neigh.replace(x_build=x_build)
        if self.triclinic:
            # A tilt beyond L/2 on a non-flippable (non-periodic) axis
            # breaks minimum_image's sequential image removal — fail
            # loudly through the overflow channel (sentinel 1<<21).
            L = state.box_hi - state.box_lo
            bound = 0.5 * jnp.stack([L[0], L[0], L[1]])
            bad = jnp.any(jnp.abs(state.tilt) > bound * (1 + 1e-6))
            neigh = neigh.replace(overflow=jnp.maximum(
                neigh.overflow, jnp.where(bad, jnp.int32(1 << 21), 0)
            ))
        if rebuild == "check":
            state, neigh = self._maybe_rebuild(state, neigh)
        elif rebuild == "always":
            # Record (don't branch on) skin violations: displacement
            # beyond skin/2 before this scheduled rebuild means the list
            # may have missed a contact — raise the cadence if nonzero.
            viol = self._stale(state, neigh).astype(jnp.int32)
            state, neigh = self._rebuild(state, neigh)
            neigh = neigh.replace(
                skin_violations=neigh.skin_violations + viol
            )
        state, neigh, aux = self.compute_forces(state, neigh)
        state = integrate.final_integrate(state, self.shapes, self.params)
        if self.press_control:
            state, x_build = integrate.berendsen_box_control(
                state, neigh.x_build, self.params, aux["virial"], self.shapes
            )
            neigh = neigh.replace(x_build=x_build)
        return state, neigh

    def step(self, state: State, neigh: NeighborState):
        return self._step_core(
            state, neigh,
            "never" if self.neighbor_mode == "static" else "check",
        )

    def run(self, state: State, neigh: NeighborState, n_steps: int):
        """Scan ``n_steps`` integration steps (jit-compiled once).

        With ``rebuild_every = R > 0`` the displacement-triggered
        lax.cond is replaced by a static cadence (LAMMPS
        ``neigh_modify every R check no``): blocks of R-1 plain steps +
        one unconditional rebuild step, all statically scheduled —
        no data-dependent branch anywhere in the loop. Skin violations
        are counted in ``neigh.skin_violations``.
        """
        if self.rebuild_every > 0 and self.neighbor_mode != "static":
            R = self.rebuild_every
            n_blocks, rem = divmod(n_steps, R)
            if n_blocks > 0:
                state, neigh = _run_cadence_jit(self, state, neigh,
                                                n_blocks, R)
            if rem:
                # The remainder stays on the static schedule: one
                # rebuild + rem-1 plain steps (a short cadence block).
                # Routing it through the check-mode path instead would
                # rebuild on every remainder step: by the end of the
                # last full block the prefilter motion budget (window =
                # R steps) is spent, so each step's lax.cond fires.
                state, neigh = _run_cadence_jit(self, state, neigh,
                                                1, rem)
            return state, neigh
        return _run_jit(self, state, neigh, n_steps)

    def run_inline(self, state: State, neigh: NeighborState, n_steps: int):
        """Traceable scan runner (for use under vmap/jit of the caller)."""

        def body(carry, _):
            return self.step(*carry), None

        (state, neigh), _ = jax.lax.scan(
            body, (state, neigh), None, length=n_steps
        )
        return state, neigh

    # -- observables --------------------------------------------------------

    def thermo(self, state: State, neigh: NeighborState) -> dict:
        """LAMMPS-thermo-style scalar table (SURVEY.md section 5.5)."""
        return _thermo_jit(self, state, neigh)

    # Identity hash: instances are static jit args.
    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


@partial(jax.jit, static_argnames=("sim", "n_steps"))
def _run_jit(sim: Simulation, state: State, neigh: NeighborState, n_steps: int):
    def body(carry, _):
        return sim.step(*carry), None

    (state, neigh), _ = jax.lax.scan(body, (state, neigh), None, length=n_steps)
    return state, neigh


@partial(jax.jit, static_argnames=("sim", "n_blocks", "r"))
def _run_cadence_jit(sim: Simulation, state: State, neigh: NeighborState,
                     n_blocks: int, r: int):
    def plain(carry, _):
        return sim._step_core(*carry, rebuild="never"), None

    def block(carry, _):
        s, ng = carry
        s, ng = sim._step_core(s, ng, rebuild="always")
        if r > 1:
            (s, ng), _ = jax.lax.scan(plain, (s, ng), None, length=r - 1)
        return (s, ng), None

    (state, neigh), _ = jax.lax.scan(
        block, (state, neigh), None, length=n_blocks
    )
    return state, neigh


@partial(jax.jit, static_argnames=("sim",))
def _init_jit(sim: Simulation, state: State):
    neigh = empty_neighbors(
        state.cap, sim.k_max, len(sim.walls), dtype=state.x.dtype,
        pair_cap=sim.pair_list_cap,
    )
    state, neigh = sim._rebuild(state, neigh)
    # The setup pass must not advance friction-spring history: the
    # first real step integrates the same configuration again, so
    # letting compute_forces tick the springs here would give
    # pre-contacting pairs a double dt of tangential displacement at
    # t0 (the reference's setup() suppresses the shear-history
    # update for the same reason). Keep f/tau, restore the history.
    hists0 = (neigh.hist, neigh.pair_hist, neigh.wall_hist)
    state, neigh, _ = sim.compute_forces(state, neigh)
    neigh = neigh.replace(
        hist=hists0[0], pair_hist=hists0[1], wall_hist=hists0[2]
    )
    return state, neigh


@partial(jax.jit, static_argnames=("sim",))
def _thermo_jit(sim: Simulation, state: State, neigh: NeighborState):
    shapes, params = sim.shapes, sim.params
    state, neigh, aux = sim.compute_forces(state, neigh)
    ke_t, ke_r = integrate.kinetic_energy(state, shapes)
    m = shapes.mass_of(state.shtype, state.scale)
    pe_grav = -jnp.sum(
        jnp.where(
            state.active,
            m * jnp.sum(
                params.gravity[None, :]
                * (state.x - sim.gravity_pe_origin[None, :]),
                axis=-1,
            ),
            0.0,
        )
    )
    vol_box = jnp.prod(state.box_hi - state.box_lo)
    kin_tensor = jnp.einsum(
        "n,na,nb->ab",
        jnp.where(state.active, m, 0.0), state.v, state.v,
        precision=jax.lax.Precision.HIGHEST,
    )
    stress = (kin_tensor + aux["virial"]) / vol_box
    return {
        "step": state.step,
        "n": state.n_active,
        "ke": ke_t,
        "erot": ke_r,
        "pe_pair": aux["pe_pair"],
        "pe_wall": aux["pe_wall"],
        "pe_grav": pe_grav,
        "etot": ke_t + ke_r + aux["pe_pair"] + aux["pe_wall"] + pe_grav,
        "press": jnp.trace(stress) / 3.0,
        "stress": stress,
        "neigh_overflow": neigh.overflow,
    }
