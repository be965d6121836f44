"""2D/3D brick domain decomposition with weighted per-axis bounds.

Extends the 1D slab decomposition (halo.py) to a brick over a device
mesh ("x", "y"[, "z"]) — the reference's ``Comm::set_proc_grid``
factorizes ranks into a 3D brick (SURVEY.md 2 B.6; 3.5). The classic
multi-phase trick makes N-D exchange a composition of N 1D exchanges
(exactly how the reference's 6-way brick exchange covers all 26
neighbors):

  migrate:  move leavers one hop along x, THEN y, THEN z — a diagonal
            migrant takes all phases within one rebuild.
  halo:     phase k ships the axis-k faces of (owned + all ghosts of
            earlier phases), so edge and corner ghosts ride the later
            phases automatically.
  forward:  re-gather each phase from the refreshed extended view of
            the previous phases (ordering matters).

Extended row layout per shard: [owned cap_local | 2*halo_cap ghosts
per sharded axis]. Everything downstream (binning windows, pair list,
forces) is inherited from ShardedSimulation unchanged.

Per-axis load balancing: ``bounds_frac`` maps each axis to weighted
slab boundaries as fractions of the box (the LAMMPS `balance x/y/z
weighted` analogue; compute with halo.balance_fracs per axis). Static
per instance, like the 1D slabs.

Not supported here (use the 1D slabs): triclinic tilt.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spherharm_tpu.core.state import State, empty_neighbors
from spherharm_tpu.ops import contact, neighbor
from spherharm_tpu.parallel.halo import (
    COMM_FIELDS,
    GhostPack,
    ShardedSimulation,
    _select_fill,
    empty_ghosts,
)


class BrickSimulation(ShardedSimulation):
    """DEM sharded over a 2D ("x","y") or 3D ("x","y","z") device mesh.

    Reuses ShardedSimulation's force/step/run machinery; overrides the
    geometry, migration and ghost exchange for multiple sharded dims.
    """

    def __init__(
        self,
        shapes,
        params,
        *,
        mesh: Mesh,
        box_lo,
        box_hi,
        cap_local: int,
        halo_cap: int,
        migrate_cap: int = 0,
        periodic=(True, True, True),
        k_max: int = 32,
        cell_cap: int = 8,
        pair_capacity: int = 0,
        pair_chunk: int = 16384,
        walls: tuple = (),
        exact_eval: bool = True,
        deform_min: float = 1.0,
        rebuild_every: int = 0,
        wall_capacity: int = 0,
        stage2_capacity: int = 0,
        conservative: bool = True,
        bounds_frac: dict | None = None,
        triclinic: bool = False,
        tilt_pad=0.0,
    ):
        if mesh.devices.ndim not in (2, 3) or mesh.axis_names != tuple(
            "xyz"[: mesh.devices.ndim]
        ):
            raise ValueError(
                "BrickSimulation needs a 2D/3D mesh with axes "
                "('x','y') or ('x','y','z')"
            )
        self.shapes = shapes
        self.params = params
        self.mesh = mesh
        self._axes = mesh.axis_names
        self.axis_sizes = dict(zip(self._axes, mesh.devices.shape))
        self.px = self.axis_sizes["x"]
        self.py = self.axis_sizes["y"]
        self.pz = self.axis_sizes.get("z", 1)
        self.n_shards = int(np.prod(mesh.devices.shape))
        self.cap_local = int(cap_local)
        self.halo_cap = int(halo_cap)
        self.migrate_cap = int(migrate_cap) or max(halo_cap // 2, 16)
        self.periodic = tuple(bool(p) for p in periodic)
        self.k_max = int(k_max)
        self.cell_cap = int(cell_cap)
        self.pair_capacity = int(pair_capacity) or 8 * cap_local
        self.pair_chunk = int(pair_chunk)
        self.walls = tuple(walls)
        self.exact_eval = bool(exact_eval)
        self.rebuild_every = int(rebuild_every)
        self.wall_capacity = int(wall_capacity)
        self.stage2_capacity = int(stage2_capacity)
        self.prefilter = (int(stage2_capacity) > 0
                          and self.pair_capacity > 0)
        # Triclinic bricks: ownership/membership stay in RAW coordinates
        # (the slab trick, halo.py:222) with per-axis halo inflation —
        # a y/z-crossing image shifts x by the tilt, so x-axis halo
        # membership must reach (|xy| + |xz|) further; y-axis reach
        # grows by |yz|; z is exact. ``tilt_pad``: scalar (applied to
        # both x and y reaches) or {"x": ..., "y": ...}.
        self.triclinic = bool(triclinic)
        if isinstance(tilt_pad, dict):
            pads = {"x": float(tilt_pad.get("x", 0.0)),
                    "y": float(tilt_pad.get("y", 0.0)), "z": 0.0}
        else:
            pads = {"x": float(tilt_pad), "y": float(tilt_pad), "z": 0.0}
        self.tilt_pads = pads
        self.tilt_pad = max(pads.values())
        if triclinic and all(v <= 0.0 for v in pads.values()):
            raise ValueError("triclinic brick needs tilt_pad > 0 "
                             "(>= max |xy|+|xz| for x, >= max |yz| for y)")
        self.conservative = bool(conservative)

        self.box_lo_np = np.asarray(box_lo, np.float64)
        self.box_hi_np = np.asarray(box_hi, np.float64)
        L = self.box_hi_np - self.box_lo_np
        cutoff_total = float(params.cutoff + params.skin)
        self.halo_depth = cutoff_total + self.tilt_pad
        self.halo_depth_ax = {
            ax: cutoff_total + pads[ax] for ax in ("x", "y", "z")
        }

        # Weighted per-axis boundaries as fractions of the box (uniform
        # by default); validated like halo.py's 1D bounds_frac.
        bounds_frac = dict(bounds_frac or {})
        self.bounds_frac = {}
        for ax in self._axes:
            n = self.axis_sizes[ax]
            bf = np.asarray(
                bounds_frac.pop(ax, np.linspace(0.0, 1.0, n + 1)),
                np.float64,
            )
            if (bf.shape != (n + 1,) or bf[0] != 0.0 or bf[-1] != 1.0
                    or np.any(np.diff(bf) <= 0)):
                raise ValueError(
                    f"bounds_frac[{ax!r}] must be increasing, length "
                    f"n_{ax}+1, with ends 0 and 1"
                )
            self.bounds_frac[ax] = bf
        if bounds_frac:
            raise ValueError(f"bounds_frac for unknown axes: "
                             f"{sorted(bounds_frac)}")
        # Narrowest brick width per axis must still cover the halo.
        self.slab_w = {}
        for d, ax in enumerate(self._axes):
            widths = np.diff(self.bounds_frac[ax]) * L[d]
            self.slab_w[ax] = float(widths.min())
            if (self.axis_sizes[ax] > 1
                    and self.slab_w[ax] < self.halo_depth_ax[ax]):
                raise ValueError(
                    f"axis {ax}: narrowest brick width "
                    f"{self.slab_w[ax]:.3g} < halo depth "
                    f"{self.halo_depth_ax[ax]:.3g}: too many shards (or "
                    "too skewed a balance) for this box"
                )
        # Static bin grid over the brick window + halo margins; unsharded
        # trailing dims span the full box. Cells must stay >= cutoff for
        # the NARROWEST brick (wider bricks get larger cells — safe).
        bin_ext = np.array([
            (self.slab_w[ax] + 2 * self.halo_depth_ax[ax])
            if ax in self._axes else L[d]
            for d, ax in enumerate("xyz")
        ])
        # Triclinic: binning runs in the unsheared frame, where a
        # raw-cutoff neighbor's displacement inflates by up to
        # |tilt|/L per coupled axis — grow the cells so the 27-stencil
        # stays complete at the padded tilt bound (the deck applies the
        # same inflation for the single-device path).
        infl = 1.0
        if triclinic:
            infl = 1.0 + min(
                (pads["x"] + pads["y"]) / float(L.min()), 1.0
            )
        dims = np.maximum(
            np.floor(float(deform_min) * bin_ext
                     / (cutoff_total * infl)).astype(int),
            1,
        )
        self.grid_dims = tuple(int(v) for v in dims)
        # Kept for the rebalance clamp: the legality floor must undo the
        # same triclinic inflation and worst-case compression the grid
        # was sized with.
        self._infl = float(infl)
        self.deform_min = float(deform_min)
        # Sharded axes use explicit seam-shifted ghosts; only unsharded
        # dims minimum-image.
        self.periodic_eff = tuple(
            self.periodic[d] and ("xyz"[d] not in self._axes)
            for d in range(3)
        )

    # -- layout ------------------------------------------------------------

    @property
    def n_axes(self) -> int:
        return len(self._axes)

    @property
    def cap_ext(self) -> int:
        return self.cap_local + 2 * self.halo_cap * self.n_axes

    def _is_sharded_leaf(self, leaf) -> bool:
        if leaf.ndim < 1 or leaf.shape[0] % self.n_shards != 0:
            return False
        per_dev = leaf.shape[0] // self.n_shards
        return per_dev in (
            self.cap_local, self.cap_ext, 2 * self.halo_cap,
            self.pair_list_cap,
        )

    def _specs(self, tree):
        return jax.tree.map(
            lambda leaf: P(self._axes) if self._is_sharded_leaf(leaf)
            else P(), tree,
        )

    # -- axis-parameterized primitives --------------------------------------

    def _ax_size(self, axis: str) -> int:
        return self.axis_sizes[axis]

    def _ring(self, val, direction: str, axis: str):
        """ppermute one hop along one mesh axis."""
        n = self._ax_size(axis)
        if direction == "left":
            perm = [(i, (i - 1) % n) for i in range(n)]
        else:
            perm = [(i, (i + 1) % n) for i in range(n)]
        return jax.lax.ppermute(val, axis, perm)

    def _edges(self, state, axis: str, fr):
        """(lo, hi) of this shard's window along the axis' coordinate.
        ``fr`` is the TRACED per-axis boundary array riding that axis'
        GhostPack (in-run rebalance swaps it, no recompile), as weighted
        fractions of the CURRENT box, so deformation rescales them
        automatically."""
        dim = "xyz".index(axis)
        idx = jax.lax.axis_index(axis)
        fr = fr.astype(state.x.dtype)
        L = state.box_hi[dim] - state.box_lo[dim]
        lo = state.box_lo[dim] + fr[idx] * L
        hi = state.box_lo[dim] + fr[idx + 1] * L
        return lo, hi

    def _has_lo(self, axis: str):
        dim = "xyz".index(axis)
        return self.periodic[dim] | (jax.lax.axis_index(axis) > 0)

    def _has_hi(self, axis: str):
        dim = "xyz".index(axis)
        n = self._ax_size(axis)
        return self.periodic[dim] | (jax.lax.axis_index(axis) < n - 1)

    def _seam(self, axis: str, state):
        """Shift VECTOR (3,) a SENT particle gets across the periodic
        seam: the full CELL VECTOR of the axis, so triclinic images are
        exact (b = (xy, Ly, 0) for y, c = (xz, yz, Lz) for z)."""
        L = state.box_hi - state.box_lo
        z = jnp.zeros((), state.x.dtype)
        if self.triclinic:
            t = state.tilt
        else:
            t = jnp.zeros((3,), state.x.dtype)
        if axis == "x":
            cv = jnp.stack([L[0], z, z])
        elif axis == "y":
            cv = jnp.stack([t[0], L[1], z])
        else:
            cv = jnp.stack([t[1], t[2], L[2]])
        idx = jax.lax.axis_index(axis)
        n = self._ax_size(axis)
        lo_send = jnp.where(idx == 0, 1.0, 0.0).astype(state.x.dtype)
        hi_send = jnp.where(idx == n - 1, -1.0, 0.0).astype(state.x.dtype)
        return lo_send * cv, hi_send * cv

    def _membership(self, coords, active, axis: str, state, fr):
        """Halo senders along one axis: rows within the axis' halo
        depth (cutoff+skin, tilt-inflated for triclinic) of a face."""
        h = self.halo_depth_ax[axis]
        lo, hi = self._edges(state, axis, fr)
        near_l = active & (coords < lo + h) & self._has_lo(axis)
        near_r = active & (coords >= hi - h) & self._has_hi(axis)
        il, vl = _select_fill(near_l, self.halo_cap)
        ir, vr = _select_fill(near_r, self.halo_cap)
        send_idx = jnp.concatenate([il, ir])
        send_mask = jnp.concatenate([vl, vr])
        overflow = jnp.maximum(jnp.sum(near_l), jnp.sum(near_r))
        return send_idx, send_mask, overflow

    def _ship_fields(self, fields: dict, send_idx, send_mask, axis: str,
                     state):
        """Gather rows at send_idx, seam-shift the axis coordinate, and
        exchange both directions. Returns received field dict + active."""
        sl, sr = self._seam(axis, state)
        H = self.halo_cap
        out = {}
        for f, arr in fields.items():
            vals = arr[send_idx]
            if f == "x":
                vals = vals.at[:H, :].add(sl).at[H:, :].add(sr)
            from_right = self._ring(vals[:H], "left", axis)
            from_left = self._ring(vals[H:], "right", axis)
            out[f] = jnp.concatenate([from_left, from_right], axis=0)
        g_active = jnp.concatenate([
            self._ring(send_mask[H:], "right", axis),
            self._ring(send_mask[:H], "left", axis),
        ])
        return out, g_active

    # -- migration (one phase per axis) --------------------------------------

    def _tgt_axis(self, state, axis: str, fr):
        dim = "xyz".index(axis)
        n = self._ax_size(axis)
        L = state.box_hi[dim] - state.box_lo[dim]
        f = (state.x[:, dim] - state.box_lo[dim]) / L
        fr = fr[1:-1].astype(state.x.dtype)
        # Weighted binning: count interior boundaries at or below f.
        tgt = jnp.sum(
            (f[:, None] >= fr[None, :]).astype(jnp.int32), axis=1
        ) if n > 1 else jnp.zeros(f.shape, jnp.int32)
        return jnp.clip(tgt, 0, n - 1)

    def _migrate_axis(self, state, neigh, axis: str, fr):
        """One 1D migration phase along a mesh axis (halo.py's _migrate
        with the axis generalized; history rows ride identically)."""
        idx = jax.lax.axis_index(axis)
        n = self._ax_size(axis)
        M = self.migrate_cap
        tgt = self._tgt_axis(state, axis, fr)
        moving = state.active & (tgt != idx) & (n > 1)
        go_left = moving & (tgt == (idx - 1) % n) & self._has_lo(axis)
        go_right = (
            moving & (tgt == (idx + 1) % n) & self._has_hi(axis) & ~go_left
        )
        far = moving & ~go_left & ~go_right
        il, vl = _select_fill(go_left, M)
        ir, vr = _select_fill(go_right, M)
        mig_overflow = jnp.maximum(jnp.sum(go_left), jnp.sum(go_right))
        mig_overflow = jnp.where(
            jnp.any(far), jnp.int32(1 << 20), mig_overflow
        )

        hist_fields = {
            "ntag": neigh.neigh_tag, "nmask": neigh.mask,
            "nhist": neigh.hist, "whist": neigh.wall_hist,
        }
        bufs = {}
        for f in COMM_FIELDS:
            arr = getattr(state, f)
            bufs[f] = (arr[il], arr[ir])
        for f, arr in hist_fields.items():
            bufs[f] = (arr[il], arr[ir])
        fields = tuple(bufs.keys())
        from_right = {
            f: self._ring(bufs[f][0], "left", axis) for f in fields
        }
        from_left = {
            f: self._ring(bufs[f][1], "right", axis) for f in fields
        }
        recv_valid = jnp.concatenate([
            self._ring(vr, "right", axis), self._ring(vl, "left", axis)
        ])
        recv = {
            f: jnp.concatenate([from_left[f], from_right[f]], axis=0)
            for f in fields
        }

        # Compact valid arrivals onto the free-slot prefix (recv_valid is
        # two prefix-valid halves — see halo.py _migrate for rationale);
        # an arrival beyond the free-slot count flags loudly.
        active = state.active & ~(go_left | go_right)
        free_idx, free_ok = _select_fill(~active, 2 * M)
        rank = jnp.where(recv_valid, jnp.cumsum(recv_valid) - 1, 2 * M - 1)
        place = recv_valid & free_ok[rank]
        slot_rows = free_idx[rank]
        slot = jnp.where(place, slot_rows, self.cap_local)
        mig_overflow = jnp.where(
            jnp.any(recv_valid & ~place), jnp.int32(1 << 20), mig_overflow
        )

        def scatter(field, val, sentinel=self.cap_local):
            pad = jnp.zeros((1,) + field.shape[1:], field.dtype)
            ext = jnp.concatenate([field, pad], axis=0)
            s = slot if sentinel == self.cap_local else jnp.where(
                place, slot_rows, sentinel
            )
            return ext.at[s].set(val)[:-1]

        new_fields = {
            f: scatter(getattr(state, f), recv[f]) for f in COMM_FIELDS
        }
        act_ext = jnp.concatenate([active, jnp.zeros((1,), bool)])
        active = act_ext.at[slot].set(place)[:-1]
        state = state.replace(active=active, **new_fields)
        ext_rows = neigh.hist.shape[0]
        neigh = neigh.replace(
            neigh_tag=scatter(neigh.neigh_tag, recv["ntag"], ext_rows),
            mask=scatter(neigh.mask, recv["nmask"], ext_rows),
            hist=scatter(neigh.hist, recv["nhist"], ext_rows),
            wall_hist=scatter(neigh.wall_hist, recv["whist"], ext_rows),
            row_tag=scatter(neigh.row_tag, recv["tag"], ext_rows),
        )
        return state, neigh, mig_overflow

    def rebalance(self, state, neigh, ghosts):
        """Per-axis in-run rebalance for the brick: marginal quantile
        cuts along each sharded mesh axis (the product-cut analogue of
        the reference's RCB balancer), with the same no-recompile
        traced-bounds mechanics and clamps as the slab version
        (ShardedSimulation.rebalance): each boundary stays strictly
        inside its old neighbors (owner moves <= 1 shard per axis — one
        forced rebuild's per-axis migration phases route it) and every
        window stays halo-legal and bin-grid-legal."""
        from spherharm_tpu.parallel.halo import (
            _rebalance_jit,
            clamped_quantile_fracs,
        )

        xs = np.asarray(jax.device_get(state.x))
        act = np.asarray(jax.device_get(state.active))
        cutoff_total = float(self.params.cutoff + self.params.skin)
        new_ghosts = []
        for k, ax in enumerate(self._axes):
            dim = "xyz".index(ax)
            n = self._ax_size(ax)
            if n < 2:
                new_ghosts.append(ghosts[k])
                continue
            old = np.asarray(jax.device_get(ghosts[k].fracs), np.float64)
            lo = float(np.asarray(state.box_lo)[dim])
            hi = float(np.asarray(state.box_hi)[dim])
            L = hi - lo
            xf = np.clip((xs[act, dim] - lo) / L, 0.0, 1.0)
            h_ax = self.halo_depth_ax[ax]
            # Mirror the init sizing (cell floor = cutoff_total * infl,
            # grid sized at deform_min compression): a window narrower
            # than this lets cells fall below the stencil-complete size
            # on a triclinic or compressing run with NO overflow flag.
            min_w = max(h_ax,
                        self.grid_dims[dim] * cutoff_total * self._infl
                        / self.deform_min - 2 * h_ax)
            qs = clamped_quantile_fracs(
                xf, old, n, min_w / L * (1.0 + 1e-3)
            )
            new_ghosts.append(ghosts[k].replace(
                fracs=jnp.asarray(qs, ghosts[k].fracs.dtype)
            ))
        return _rebalance_jit(self, state, neigh, tuple(new_ghosts))

    def _migrate(self, state, neigh, fracs):
        ovf = jnp.asarray(0, jnp.int32)
        for ax in self._axes:
            state, neigh, o = self._migrate_axis(state, neigh, ax,
                                                 fracs[ax])
            ovf = jnp.maximum(ovf, o)
        return state, neigh, ovf

    # -- extended view -------------------------------------------------------

    def _extend(self, state: State, ghosts):
        """owned + per-axis ghosts into one extended State view."""
        n_g = 2 * self.halo_cap * self.n_axes
        z3 = jnp.zeros((n_g, 3), state.x.dtype)

        def cat(f):
            return jnp.concatenate(
                [getattr(state, f)] + [getattr(g, f) for g in ghosts]
            )

        return state.replace(
            x=cat("x"), v=cat("v"), q=cat("q"), angmom=cat("angmom"),
            scale=cat("scale"), shtype=cat("shtype"), tag=cat("tag"),
            active=cat("active"),
            f=jnp.concatenate([state.f, z3]),
            tau=jnp.concatenate([state.tau, z3]),
            image=jnp.concatenate(
                [state.image, jnp.zeros((n_g, 3), jnp.int32)]
            ),
        )

    def _owned_mask(self, dtype=bool):
        return jnp.concatenate([
            jnp.ones((self.cap_local,), bool),
            jnp.zeros((2 * self.halo_cap * self.n_axes,), bool),
        ])

    # -- halo build / refresh ------------------------------------------------

    def _build_ghosts(self, state: State, fracs):
        """Multi-phase halo: axis-k faces of owned + earlier ghosts, so
        edge/corner ghosts ride the later phases. ``fracs``: per-axis
        traced boundary arrays; each phase's pack carries its axis'
        array (in-run rebalance swaps them, no recompile)."""
        send_f = ("x", "v", "q", "angmom", "scale", "shtype", "tag")
        ext = {f: getattr(state, f) for f in send_f}
        act = state.active
        ghosts = []
        ovf = jnp.asarray(0, jnp.int32)
        for ax in self._axes:
            dim = "xyz".index(ax)
            s_idx, s_mask, o = self._membership(
                ext["x"][:, dim], act, ax, state, fracs[ax]
            )
            recv, g_act = self._ship_fields(ext, s_idx, s_mask, ax, state)
            g = GhostPack(
                x=recv["x"], v=recv["v"], q=recv["q"],
                angmom=recv["angmom"], scale=recv["scale"],
                shtype=recv["shtype"], tag=recv["tag"],
                active=g_act, send_idx=s_idx, send_mask=s_mask,
                fracs=fracs[ax],
            )
            ghosts.append(g)
            ovf = jnp.maximum(ovf, o)
            ext = {
                f: jnp.concatenate([ext[f], recv[f]]) for f in send_f
            }
            act = jnp.concatenate([act, g_act])
        return tuple(ghosts), ovf

    def _forward_comm(self, state: State, neigh, ghosts):
        """Per-step ghost refresh: each phase re-gathers from the
        refreshed extended view of the previous phases (same routing as
        the last rebuild)."""
        dyn = ("x", "v", "q", "angmom")
        ext = {f: getattr(state, f) for f in dyn}
        new_ghosts = []
        for g, ax in zip(ghosts, self._axes):
            recv, _ = self._ship_fields(ext, g.send_idx, g.send_mask, ax,
                                        state)
            g = g.replace(x=recv["x"], v=recv["v"], q=recv["q"],
                          angmom=recv["angmom"])
            new_ghosts.append(g)
            ext = {f: jnp.concatenate([ext[f], recv[f]]) for f in dyn}
        return state, neigh, tuple(new_ghosts)

    def _rebuild(self, state: State, neigh, ghosts, fold: bool = True):
        x, image = neighbor.wrap_positions(
            state.x, state.image, state.box_lo, state.box_hi, self.periodic,
            tilt=self._tilt(state),
        )
        state = state.replace(x=x, image=image)
        if fold:
            neigh = neigh.replace(hist=contact.pair_hist_to_dense(neigh))
        fracs = {ax: g.fracs for ax, g in zip(self._axes, ghosts)}
        state, neigh, mig_ovf = self._migrate(state, neigh, fracs)

        ghosts, halo_ovf = self._build_ghosts(state, fracs)
        ext = self._extend(state, ghosts)

        lo3, hi3 = [], []
        for d, ax in enumerate("xyz"):
            if ax in self._axes:
                lo, hi = self._edges(state, ax, fracs[ax])
                lo3.append(lo - self.halo_depth_ax[ax])
                hi3.append(hi + self.halo_depth_ax[ax])
            else:
                lo3.append(state.box_lo[d])
                hi3.append(state.box_hi[d])
        bin_lo = jnp.stack(lo3)
        bin_hi = jnp.stack(hi3)
        cutoff = self.params.cutoff + self.params.skin
        owned = self._owned_mask()
        nidx, nmask, count, cell_ovf = neighbor.cell_list_neighbors(
            ext.x, ext.active, state.box_lo, state.box_hi, cutoff,
            self.grid_dims, self.cell_cap, self.k_max, self.periodic_eff,
            bin_lo=bin_lo, bin_hi=bin_hi, owned=owned & ext.active,
            tilt=self._tilt(state),
        )
        neigh_tag = jnp.where(nmask, ext.tag[nidx], 0)
        row_ok = neigh.row_tag == ext.tag
        hist = neighbor.remap_history(
            neigh_tag, nmask, neigh.neigh_tag, neigh.mask, neigh.hist, row_ok
        )
        pair_fields, n_pairs = contact.build_pair_list(
            ext, self.shapes, self.params, nidx, nmask, hist,
            owned & ext.active, self.pair_capacity, self.periodic_eff,
            tilt=self._tilt(state),
        )
        n_surv = jnp.asarray(0, jnp.int32)
        if self.prefilter:
            pair_fields, n_surv, budget = contact.prefilter_pair_list(
                ext, self.shapes, self.params, pair_fields,
                self.stage2_capacity, self.k_max,
                window_steps=self._window_steps,
                periodic=self.periodic_eff,
                tilt=self._tilt(state),
                axes=self._axes,
            )
            neigh = neigh.replace(budget=budget)
        # Per-source gating (see ShardedSimulation._rebuild): nonzero
        # overflow always means some capacity was actually exceeded.
        mx = jnp.max(count)
        overflow = jnp.maximum(
            jnp.maximum(jnp.where(mx > self.k_max, mx, 0),
                        jnp.where(cell_ovf > self.cell_cap, cell_ovf, 0)),
            jnp.maximum(
                jnp.where(mig_ovf > self.migrate_cap, mig_ovf, 0),
                jnp.where(halo_ovf > self.halo_cap, halo_ovf, 0),
            ),
        )
        overflow = jnp.maximum(
            overflow, jnp.where(n_pairs > self.pair_capacity, n_pairs, 0)
        )
        if self.prefilter:
            overflow = jnp.maximum(
                overflow,
                jnp.where(n_surv > self.stage2_capacity, n_surv, 0),
            )
        overflow = jax.lax.pmax(overflow, self._axes)
        neigh = neigh.replace(
            idx=nidx, mask=nmask, hist=hist, neigh_tag=neigh_tag,
            row_tag=ext.tag, x_build=ext.x, q_build=ext.q,
            overflow=jnp.maximum(neigh.overflow, overflow),
            **pair_fields,
        )
        return state, neigh, ghosts

    # -- distribution --------------------------------------------------------

    def distribute(self, state_global: State, restart: dict | None = None):
        """Partition a global State into weighted brick blocks (raw-
        coordinate ownership; triclinic needs triclinic=True + pads)."""
        tilt0 = np.asarray(state_global.tilt, np.float64)
        if not self.triclinic and bool(np.any(tilt0 != 0.0)):
            raise ValueError(
                "state has triclinic tilt but the brick was built with "
                "triclinic=False — pass triclinic=True and tilt_pad"
            )
        if self.triclinic:
            need_x = abs(tilt0[0]) + abs(tilt0[1])
            need_y = abs(tilt0[2])
            if (need_x > self.tilt_pads["x"] + 1e-9
                    or need_y > self.tilt_pads["y"] + 1e-9):
                raise ValueError(
                    f"initial tilt {tilt0} exceeds tilt_pad "
                    f"{self.tilt_pads} — halos would under-reach"
                )
        P_ = self.n_shards
        x = np.asarray(state_global.x)
        active = np.asarray(state_global.active)
        L = self.box_hi_np - self.box_lo_np
        # Weighted per-axis block index; flat block id in mesh order
        # (row-major over the mesh axes — matches P(("x","y","z"))
        # sharding of a leading-axis concat).
        block = np.zeros(x.shape[0], np.int64)
        for ax in self._axes:
            d = "xyz".index(ax)
            f = (x[:, d] - self.box_lo_np[d]) / L[d]
            interior = self.bounds_frac[ax][1:-1]
            b = np.clip(
                np.searchsorted(interior, f, side="right"),
                0, self.axis_sizes[ax] - 1,
            )
            block = block * self.axis_sizes[ax] + b
        locals_ = []
        sels = []
        for p in range(P_):
            sel = np.flatnonzero(active & (block == p))
            if sel.size > self.cap_local:
                raise ValueError(
                    f"brick {p} holds {sel.size} > cap_local={self.cap_local}"
                )
            sels.append(sel)
            pad = self.cap_local - sel.size
            rows = {}
            for f in COMM_FIELDS + ("active",):
                v = np.asarray(getattr(state_global, f))[sel]
                v = np.concatenate(
                    [v, np.zeros((pad,) + v.shape[1:], v.dtype)], axis=0
                )
                rows[f] = v
            rows["active"][sel.size:] = False
            rows["q"][sel.size:, 0] = 1.0
            rows["scale"][sel.size:] = 1.0
            locals_.append(rows)

        def cat(f):
            return jnp.asarray(np.concatenate([loc[f] for loc in locals_]))

        dtype = state_global.x.dtype
        st = State(
            x=cat("x").astype(dtype), v=cat("v").astype(dtype),
            q=cat("q").astype(dtype), angmom=cat("angmom").astype(dtype),
            f=jnp.zeros((P_ * self.cap_local, 3), dtype),
            tau=jnp.zeros((P_ * self.cap_local, 3), dtype),
            scale=cat("scale").astype(dtype), shtype=cat("shtype"),
            tag=cat("tag"), active=cat("active"), image=cat("image"),
            box_lo=state_global.box_lo, box_hi=state_global.box_hi,
            tilt=state_global.tilt, step=state_global.step,
        )
        neigh = empty_neighbors(
            P_ * self.cap_ext, self.k_max, len(self.walls), dtype=dtype,
            pair_cap=P_ * self.pair_list_cap,
        )
        if restart is not None:
            ce, K = self.cap_ext, self.k_max
            hw = neigh.hist.shape[-1]
            W = neigh.wall_hist.shape[1]
            nt = np.zeros((P_ * ce, K), np.int32)
            nh = np.zeros((P_ * ce, K, hw), np.float32)
            wh = np.zeros((P_ * ce, W, hw), np.float32)
            rt = np.zeros((P_ * ce,), np.int32)
            tags_g = np.asarray(state_global.tag)
            for p, sel in enumerate(sels):
                rows = slice(p * ce, p * ce + sel.size)
                nt[rows] = np.asarray(restart["hist_tags"])[sel]
                nh[rows] = np.asarray(restart["hist"])[sel]
                if W:
                    wh[rows] = np.asarray(restart["wall_hist"])[sel]
                rt[rows] = tags_g[sel]
            neigh = neigh.replace(
                neigh_tag=jnp.asarray(nt),
                hist=jnp.asarray(nh, neigh.hist.dtype),
                wall_hist=jnp.asarray(wh, neigh.wall_hist.dtype),
                row_tag=jnp.asarray(rt),
                mask=jnp.asarray(nt > 0),
            )
        ghosts = tuple(
            jax.tree.map(
                lambda a: jnp.concatenate([a] * P_, axis=0),
                empty_ghosts(self.halo_cap, dtype),
            ).replace(fracs=jnp.asarray(self.bounds_frac[ax], dtype))
            for ax in self._axes
        )
        sharding = NamedSharding(self.mesh, P(self._axes))

        def put(leaf):
            if self._is_sharded_leaf(leaf):
                return jax.device_put(leaf, sharding)
            return jax.device_put(leaf, NamedSharding(self.mesh, P()))

        st = jax.tree.map(put, st)
        neigh = jax.tree.map(put, neigh)
        ghosts = jax.tree.map(put, ghosts)
        return st, neigh, ghosts


class Brick2DSimulation(BrickSimulation):
    """Back-compat alias: the 2D ("x","y") brick."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.n_axes != 2:
            raise ValueError("Brick2DSimulation needs a 2D ('x','y') mesh")
