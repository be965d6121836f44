"""Spatial domain decomposition over a device mesh: slabs + ppermute halos.

Collective-based replacement for the reference's MPI Comm layer (SURVEY.md
section 2 B.6 / 3.5; contract BASELINE.json:5 "MPI spatial domain
decomposition and ghost-atom exchange are replaced by sharded particle
arrays with jax.lax collectives across a device mesh"). Mapping of the
reference's comm surface:

  Comm::exchange()      -> migrate(): leavers selected into fixed-capacity
                           buffers, lax.ppermute to ring neighbors, merged
                           into free slots (rebuild steps only)
  Comm::borders()       -> halo membership re-selection at rebuild: owned
                           particles within cutoff+skin of a slab face
  Comm::forward_comm()  -> every step: gather (x, v, q, angmom) at the
                           stored send indices, ppermute, refresh ghosts
  Comm::reverse_comm()  -> NOT NEEDED: the neighbor list is a FULL list,
                           every owner computes its own forces from ghosts
                           (Newton-off in LAMMPS terms — the scatter-free
                           choice)
  MPI_Allreduce         -> lax.psum / lax.pmax for thermo and the global
                           neighbor-rebuild decision

Decomposition: 1D slabs along x over a mesh axis "x" (a ring). Each
device owns ``cap_local`` fixed particle slots (masked). Ghost slots:
[:H] mirror the LEFT neighbor's right edge, [H:] the RIGHT neighbor's
left edge; the periodic seam is handled by the sender shifting x by
+/- Lx, so every downstream computation sees explicit coordinates and
NO minimum-imaging is needed along x.

Migrating particles carry their tangential-spring history (pair and
wall springs) inside the migration buffers, matching the reference's
FixNeighHistory-rides-pack_exchange behavior (SURVEY.md 3.4).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from spherharm_tpu.utils import struct
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spherharm_tpu.core.state import (
    NeighborState,
    State,
    empty_neighbors,
)
from spherharm_tpu.ops import contact, integrate, neighbor, walls as walls_mod

# Particle fields that travel in migration / halo buffers.
COMM_FIELDS = ("x", "v", "q", "angmom", "scale", "shtype", "tag", "image")


def balance_fracs(state_global, n_shards: int, min_frac: float = 0.0,
                  axis: int = 0):
    """Weighted slab boundaries for equal particle counts per shard.

    The LAMMPS ``balance x weighted`` analogue (SURVEY.md 2 B.6: the
    reference's RCB balancer reduces to weighted 1D cuts for a slab
    decomposition). Returns ``bounds_frac`` for ShardedSimulation:
    per-shard x-quantiles of the active particles, clamped so no slab
    is narrower than ``min_frac`` of the box (pass
    (cutoff + skin + tilt_pad) / Lx to keep every slab halo-legal).
    ``axis`` selects the coordinate (0/1/2) — the brick decomposition
    calls this once per sharded mesh axis to build its per-axis
    ``bounds_frac`` dict.
    For INITIAL bounds. Mid-run, use ShardedSimulation.rebalance():
    the bounds are a traced GhostPack leaf, so rebalancing swaps the
    array with no recompile (drastic re-cuts beyond +/- one slab per
    boundary still go through gather_restart -> new sim).
    """
    x = np.asarray(state_global.x)
    act = np.asarray(state_global.active)
    lo = float(np.asarray(state_global.box_lo)[axis])
    hi = float(np.asarray(state_global.box_hi)[axis])
    xf = np.clip((x[act, axis] - lo) / (hi - lo), 0.0, 1.0)
    qs = np.quantile(xf, np.linspace(0.0, 1.0, n_shards + 1))
    qs[0], qs[-1] = 0.0, 1.0
    if min_frac > 0.0:
        if min_frac * n_shards > 1.0:
            raise ValueError("min_frac too large for this shard count")
        for i in range(1, n_shards):          # left-to-right pass
            qs[i] = max(qs[i], qs[i - 1] + min_frac)
        for i in range(n_shards - 1, 0, -1):  # right-to-left pass
            qs[i] = min(qs[i], qs[i + 1] - min_frac)
    return qs


def clamped_quantile_fracs(xf, old, n: int, min_frac: float):
    """Equal-count boundary fractions for one axis, clamped for in-run
    rebalancing: each interior boundary stays strictly inside its OLD
    neighbors (ownership moves at most one shard — routable by the
    +/-1-hop migration ring in one forced rebuild) and every window
    keeps at least ``min_frac`` width (halo + bin-grid legality).
    Shared by the slab and brick rebalancers."""
    qs = np.quantile(xf, np.linspace(0.0, 1.0, n + 1))
    qs[0], qs[-1] = 0.0, 1.0
    for i in range(1, n):
        qs[i] = np.clip(qs[i], old[i - 1] + min_frac,
                        old[i + 1] - min_frac)
    for i in range(1, n):          # monotone + min width, L->R
        qs[i] = max(qs[i], qs[i - 1] + min_frac)
    for i in range(n - 1, 0, -1):  # R->L
        qs[i] = min(qs[i], qs[i + 1] - min_frac)
    if np.any(np.diff(qs) <= 0):
        raise ValueError(
            f"rebalance could not find halo-legal bounds "
            f"(min_frac={min_frac:.3g}, n={n})"
        )
    return qs


@struct.dataclass
class GhostPack:
    """Ghost mirrors + forward-comm routing (rebuilt at each re-neighbor)."""

    x: jax.Array        # [2H, 3]
    v: jax.Array        # [2H, 3]
    q: jax.Array        # [2H, 4]
    angmom: jax.Array   # [2H, 3]
    scale: jax.Array    # [2H]
    shtype: jax.Array   # [2H] int32
    tag: jax.Array      # [2H] int32
    active: jax.Array   # [2H] bool
    send_idx: jax.Array   # [2H] int32: my slots to forward ([:H] left, [H:] right)
    send_mask: jax.Array  # [2H] bool
    # [S+1] slab boundaries as box FRACTIONS, replicated across shards.
    # A traced leaf (not a baked constant) so in-run rebalancing
    # (ShardedSimulation.rebalance) only swaps the array — no recompile.
    # The brick carries ONE AXIS' boundaries per phase pack.
    fracs: jax.Array | None = None


def empty_ghosts(h_cap: int, dtype=jnp.float32, fracs=None) -> GhostPack:
    H2 = 2 * h_cap
    return GhostPack(
        fracs=fracs,
        x=jnp.zeros((H2, 3), dtype), v=jnp.zeros((H2, 3), dtype),
        q=jnp.zeros((H2, 4), dtype).at[:, 0].set(1.0),
        angmom=jnp.zeros((H2, 3), dtype),
        scale=jnp.ones((H2,), dtype),
        shtype=jnp.zeros((H2,), jnp.int32),
        tag=jnp.zeros((H2,), jnp.int32),
        active=jnp.zeros((H2,), bool),
        send_idx=jnp.zeros((H2,), jnp.int32),
        send_mask=jnp.zeros((H2,), bool),
    )


def _select_fill(mask, cap: int):
    """Indices of up to ``cap`` True entries of mask (stable), + validity."""
    score = jnp.where(mask, 1.0, 0.0)
    _, idx = jax.lax.top_k(score, cap)
    valid = jnp.take(mask, idx)
    return idx.astype(jnp.int32), valid


class ShardedSimulation:
    """Slab-sharded DEM over a 1D device mesh (config 5, BASELINE.json:11).

    Static config mirrors ``Simulation``; state/neighbors/ghosts ride in
    pytrees whose per-particle leaves are sharded over mesh axis "x".
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
        triclinic: bool = False,
        tilt_pad: float = 0.0,
        bounds_frac=None,
        conservative: bool = True,
    ):
        self.shapes = shapes
        self.params = params
        self.mesh = mesh
        self.n_shards = mesh.devices.size
        self._axes = ("x",)   # collective axes (Brick2D overrides)
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
        # Rebuild-time narrow-phase prefilter (see core/simulation.py +
        # contact.prefilter_pair_list): the persistent pair list is the
        # stage-2 compaction of the candidate list.
        self.prefilter = (int(stage2_capacity) > 0
                          and self.pair_capacity > 0)
        self.conservative = bool(conservative)
        # Triclinic slab decomposition: a y/z-crossing image shifts x by
        # the tilt, so raw-x halo membership must reach tilt_pad further
        # (set tilt_pad >= max |xy| + |xz| the run will see).
        self.triclinic = bool(triclinic)
        self.tilt_pad = float(tilt_pad)
        if triclinic and tilt_pad <= 0.0:
            raise ValueError("triclinic sharding needs tilt_pad >= max "
                             "|xy|+|xz| expected during the run")

        self.box_lo_np = np.asarray(box_lo, np.float64)
        self.box_hi_np = np.asarray(box_hi, np.float64)
        Lx = self.box_hi_np[0] - self.box_lo_np[0]
        # Weighted (load-balanced) slab boundaries, as FRACTIONS of the
        # box (so box deformation rescales them automatically). Default:
        # uniform slabs. The LAMMPS `balance x uniform|weighted`
        # analogue — compute fracs with balance_fracs(). Static per sim
        # instance: rebalancing constructs a new sim (recompile), which
        # matches how rarely the reference rebalances.
        if bounds_frac is None:
            bounds_frac = np.linspace(0.0, 1.0, self.n_shards + 1)
        self.bounds_frac = np.asarray(bounds_frac, np.float64)
        if (self.bounds_frac.shape != (self.n_shards + 1,)
                or self.bounds_frac[0] != 0.0 or self.bounds_frac[-1] != 1.0
                or np.any(np.diff(self.bounds_frac) <= 0)):
            raise ValueError(
                "bounds_frac must be increasing, length n_shards+1, "
                "with ends 0 and 1"
            )
        slab_widths = np.diff(self.bounds_frac) * Lx
        self.slab_w = float(slab_widths.min())
        cutoff_total = float(params.cutoff + params.skin)
        self.halo_depth = cutoff_total + self.tilt_pad
        if self.slab_w < self.halo_depth:
            raise ValueError(
                f"narrowest slab {self.slab_w:.3g} < cutoff+skin "
                f"{self.halo_depth:.3g}: too many shards (or too skewed "
                "a balance) for this box"
            )
        # Static per-device bin grid covering slab + halo margin. The
        # grid DIMS are one static program constant across shards while
        # the binning EXTENT is dynamic per shard, so cells must stay
        # >= cutoff for the NARROWEST slab (widest slabs just get
        # larger cells, which is always safe for the stencil).
        bin_lo = np.array(
            [-self.halo_depth, self.box_lo_np[1], self.box_lo_np[2]]
        )
        bin_hi = np.array(
            [self.slab_w + self.halo_depth, self.box_hi_np[1], self.box_hi_np[2]]
        )
        # Size the static grid for the SMALLEST box the run will see
        # (deform_min < 1 when the triaxial cell compresses), so cells
        # never shrink below cutoff+skin.
        dims = np.maximum(
            np.floor(float(deform_min) * (bin_hi - bin_lo) / cutoff_total)
            .astype(int),
            1,
        )
        self.grid_dims = tuple(int(v) for v in dims)
        # Kept for the rebalance clamp: the bin-grid legality floor must
        # use the SAME worst-case compression the grid was sized with.
        self.deform_min = float(deform_min)
        # Periodicity for pair math: x images are explicit ghosts.
        self.periodic_eff = (False, self.periodic[1], self.periodic[2])

    # -- sharding specs ----------------------------------------------------

    def _is_sharded_leaf(self, leaf) -> bool:
        """Per-particle leaves (global shape P * {cap_local, cap_ext, 2H})."""
        if leaf.ndim < 1 or leaf.shape[0] % self.n_shards != 0:
            return False
        per_dev = leaf.shape[0] // self.n_shards
        return per_dev in (self.cap_local, self.cap_ext, 2 * self.halo_cap,
                           self.pair_capacity, self.pair_list_cap)

    def _specs(self, tree):
        return jax.tree.map(
            lambda leaf: P("x") if self._is_sharded_leaf(leaf) else P(), tree
        )

    @property
    def cap_ext(self) -> int:
        return self.cap_local + 2 * self.halo_cap

    # -- distribution (host-side) ------------------------------------------

    def distribute(self, state_global: State, restart: dict | None = None):
        """Partition a single-box State into sharded per-slab slots.

        ``restart`` (from :meth:`gather_restart`) carries tag-keyed
        contact history aligned with ``state_global``'s rows:
        ``hist_tags`` [n, K], ``hist`` [n, K, HW], ``wall_hist``
        [n, W, HW]. It seeds the neighbor state's durable (rebuild-time)
        layout so the first rebuild's remap recovers every spring.
        """
        P_ = self.n_shards
        x = np.asarray(state_global.x)
        active = np.asarray(state_global.active)
        Lx_np = self.box_hi_np[0] - self.box_lo_np[0]
        xf = (x[:, 0] - self.box_lo_np[0]) / Lx_np
        slab = np.clip(
            np.searchsorted(self.bounds_frac[1:-1], xf, side="right"),
            0, P_ - 1,
        )
        locals_ = []
        sels = []
        for p in range(P_):
            sel = np.flatnonzero(active & (slab == p))
            if sel.size > self.cap_local:
                raise ValueError(
                    f"slab {p} holds {sel.size} > cap_local={self.cap_local}"
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
            # Seed the durable tag-keyed layout in the EXT row space
            # (owned rows lead each shard block); _init_jit skips the
            # pair->dense fold so this survives to the remap.
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
        # wall_hist rows only needed for owned slots; keep cap_ext for shape
        # uniformity with the neighbor rows.
        ghosts = jax.tree.map(
            lambda a: jnp.concatenate([a] * P_, axis=0),
            empty_ghosts(self.halo_cap, dtype),
        )
        # The slab bounds ride the GhostPack as a TRACED (replicated)
        # leaf: rebalance() swaps the array without recompiling.
        ghosts = ghosts.replace(
            fracs=jnp.asarray(self.bounds_frac, dtype)
        )
        sharding = NamedSharding(self.mesh, P("x"))

        def put(leaf):
            if self._is_sharded_leaf(leaf):
                return jax.device_put(leaf, sharding)
            return jax.device_put(leaf, NamedSharding(self.mesh, P()))

        st = jax.tree.map(put, st)
        neigh = jax.tree.map(put, neigh)
        ghosts = jax.tree.map(put, ghosts)
        return st, neigh, ghosts

    # -- per-device building blocks (called inside shard_map) ---------------

    def _ring_shift(self, val, direction: str):
        """ppermute one hop around the ring. direction='left' sends to
        device idx-1 (so I receive my RIGHT neighbor's buffer)."""
        P_ = self.n_shards
        if direction == "left":
            perm = [(i, (i - 1) % P_) for i in range(P_)]
        else:
            perm = [(i, (i + 1) % P_) for i in range(P_)]
        return jax.lax.ppermute(val, "x", perm)

    def _seam_shifts(self, idx, state):
        """x-shift a SENT particle gets (periodic seam unwrap)."""
        Lx = state.box_hi[0] - state.box_lo[0]
        left_send = jnp.where(idx == 0, Lx, 0.0)       # 0 -> P-1: x += Lx
        right_send = jnp.where(idx == self.n_shards - 1, -Lx, 0.0)
        return (left_send.astype(state.x.dtype),
                right_send.astype(state.x.dtype))

    def _slab_edges(self, state, idx, fracs):
        """(slab_lo, slab_hi) of shard ``idx`` under weighted bounds.

        ``fracs`` is the TRACED [S+1] boundary array riding the
        GhostPack (in-run rebalance swaps it with no recompile), as
        fractions of the CURRENT box length, so deformation rescales
        the decomposition with the cell.
        """
        fr = fracs.astype(state.x.dtype)
        Lx = state.box_hi[0] - state.box_lo[0]
        return (state.box_lo[0] + fr[idx] * Lx,
                state.box_lo[0] + fr[idx + 1] * Lx)

    def _slab_of(self, state, x0, fracs):
        """Owner shard of x-coordinates ``x0`` (weighted searchsorted)."""
        fr = fracs[1:-1].astype(state.x.dtype)
        Lx = state.box_hi[0] - state.box_lo[0]
        xf = (x0 - state.box_lo[0]) / Lx
        return jnp.clip(
            jnp.searchsorted(fr, xf, side="right").astype(jnp.int32),
            0, self.n_shards - 1,
        )

    def _has_left(self, idx):
        return self.periodic[0] | (idx > 0)

    def _has_right(self, idx):
        return self.periodic[0] | (idx < self.n_shards - 1)

    def _gather_send(self, state, send_idx, send_mask):
        """Gather + ship forward-comm fields; returns ghost field dict."""
        idx = jax.lax.axis_index("x")
        sl, sr = self._seam_shifts(idx, state)
        H = self.halo_cap
        out = {}
        for f in ("x", "v", "q", "angmom"):
            vals = getattr(state, f)[send_idx]
            if f == "x":
                vals = vals.at[:H, 0].add(sl).at[H:, 0].add(sr)
            from_right = self._ring_shift(vals[:H], "left")
            from_left = self._ring_shift(vals[H:], "right")
            out[f] = jnp.concatenate([from_left, from_right], axis=0)
        return out

    def _halo_membership(self, state, fracs):
        """Select owned particles within halo_depth of each slab face."""
        idx = jax.lax.axis_index("x")
        slab_lo, slab_hi = self._slab_edges(state, idx, fracs)
        near_l = state.active & (state.x[:, 0] < slab_lo + self.halo_depth)
        near_r = state.active & (state.x[:, 0] >= slab_hi - self.halo_depth)
        near_l = near_l & self._has_left(idx)
        near_r = near_r & self._has_right(idx)
        il, vl = _select_fill(near_l, self.halo_cap)
        ir, vr = _select_fill(near_r, self.halo_cap)
        send_idx = jnp.concatenate([il, ir])
        send_mask = jnp.concatenate([vl, vr])
        overflow = jnp.maximum(jnp.sum(near_l), jnp.sum(near_r))
        return send_idx, send_mask, overflow

    def _migrate(self, state, neigh, fracs):
        """Move owned particles whose slab changed to ring neighbors.

        Positions are wrapped BEFORE migration (in _rebuild), so a
        seam-crossing particle's x is already inside the destination
        slab's coordinate range — migration buffers carry coordinates
        verbatim, with NO seam unwrap (+/-Lx is only for halo ghost
        export, where explicit out-of-box images are intended).

        Contact history migrates with the particle: the old-list row
        (neigh_tag, mask, hist) plus wall springs are shipped and
        scattered into the receiver's neighbor arrays keyed by the new
        slot, with row_tag set to the arriving tag, so the subsequent
        remap_history carries the springs into the new build — the
        analogue of FixNeighHistory state riding AtomVec
        pack_exchange (SURVEY.md 3.4 "contact history survives").
        """
        idx = jax.lax.axis_index("x")
        P_ = self.n_shards
        M = self.migrate_cap
        tgt = self._slab_of(state, state.x[:, 0], fracs)
        moving = state.active & (tgt != idx) & (P_ > 1)
        go_left = moving & (tgt == (idx - 1) % P_) & self._has_left(idx)
        # On a 2-shard ring left and right neighbor coincide: ~go_left
        # keeps each migrant in exactly one buffer (no duplication).
        go_right = (
            moving & (tgt == (idx + 1) % P_) & self._has_right(idx) & ~go_left
        )
        # Particles more than one slab from home (huge dt or too-sparse
        # rebuild cadence) can't be routed on the ring in one hop; flag
        # loudly through the overflow channel instead of silently
        # mis-owning them.
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
            f: self._ring_shift(bufs[f][0], "left") for f in fields
        }
        from_left = {
            f: self._ring_shift(bufs[f][1], "right") for f in fields
        }
        recv_valid = jnp.concatenate(
            [self._ring_shift(vr, "right"), self._ring_shift(vl, "left")]
        )
        recv = {
            f: jnp.concatenate([from_left[f], from_right[f]], axis=0)
            for f in fields
        }

        # Deactivate leavers, then place arrivals into free slots. Writes
        # for unplaced arrivals are routed to a sacrificial pad row.
        # recv_valid is TWO prefix-valid halves (left|right buffers), so
        # pairing arrival i with free slot i would starve the second half
        # whenever fewer than 2M slots are free: compact instead — the
        # k-th VALID arrival takes the k-th free slot. An arrival beyond
        # the free-slot count is a genuine cap_local overflow and is
        # flagged through the overflow channel, never silently dropped.
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
        # Arrivals' old-list history lands at their new slot; row_tag is
        # set to the arriving tag so remap_history's row_ok guard passes.
        ext_rows = neigh.hist.shape[0]
        neigh = neigh.replace(
            neigh_tag=scatter(neigh.neigh_tag, recv["ntag"], ext_rows),
            mask=scatter(neigh.mask, recv["nmask"], ext_rows),
            hist=scatter(neigh.hist, recv["nhist"], ext_rows),
            wall_hist=scatter(neigh.wall_hist, recv["whist"], ext_rows),
            row_tag=scatter(neigh.row_tag, recv["tag"], ext_rows),
        )
        return state, neigh, mig_overflow

    def _extend(self, state: State, ghosts: GhostPack):
        """Concatenate owned + ghost slots into one extended State view."""
        z3 = jnp.zeros((2 * self.halo_cap, 3), state.x.dtype)
        return state.replace(
            x=jnp.concatenate([state.x, ghosts.x]),
            v=jnp.concatenate([state.v, ghosts.v]),
            q=jnp.concatenate([state.q, ghosts.q]),
            angmom=jnp.concatenate([state.angmom, ghosts.angmom]),
            scale=jnp.concatenate([state.scale, ghosts.scale]),
            shtype=jnp.concatenate([state.shtype, ghosts.shtype]),
            tag=jnp.concatenate([state.tag, ghosts.tag]),
            active=jnp.concatenate([state.active, ghosts.active]),
            f=jnp.concatenate([state.f, z3]),
            tau=jnp.concatenate([state.tau, z3]),
            image=jnp.concatenate(
                [state.image, jnp.zeros((2 * self.halo_cap, 3), jnp.int32)]
            ),
        )

    def _owned_mask(self, dtype=bool):
        return jnp.concatenate([
            jnp.ones((self.cap_local,), bool),
            jnp.zeros((2 * self.halo_cap,), bool),
        ])

    @property
    def pair_list_cap(self) -> int:
        """Persistent per-shard pair-list capacity (the prefiltered
        stage-2 cap when the rebuild-time prefilter is on)."""
        return (self.stage2_capacity if self.prefilter
                else self.pair_capacity)

    @property
    def _window_steps(self) -> int:
        """Motion-budget horizon of the prefilter (see
        core.Simulation._window_steps)."""
        return self.rebuild_every if self.rebuild_every > 0 else 16

    def _stale(self, state, neigh):
        """pmax'd rebuild trigger (see core.Simulation._stale): budget-
        ratio check for the prefiltered pair list (each shard checks its
        OWNED rows — ghosts are re-checked by their owner), plain
        skin/2 displacement otherwise."""
        if self.prefilter:
            gmax_s = self.shapes.gmax[state.shtype] * state.scale
            ratio = neighbor.approach_ratio(
                state.x, neigh.x_build[: self.cap_local], state.q,
                neigh.q_build[: self.cap_local], gmax_s,
                neigh.budget[: self.cap_local], state.active,
                state.box_lo, state.box_hi, self.periodic,
                tilt=self._tilt(state),
            )
            return jax.lax.pmax(ratio, self._axes) > 1.0
        disp2 = neighbor.max_displacement2(
            state.x, neigh.x_build[: self.cap_local], state.active,
            state.box_lo, state.box_hi, self.periodic,
            tilt=self._tilt(state),
        )
        return jax.lax.pmax(disp2, self._axes) > (0.5 * self.params.skin) ** 2

    def _tilt(self, state: State):
        return state.tilt if self.triclinic else None

    def _rebuild(self, state: State, neigh: NeighborState, ghosts: GhostPack,
                 fold: bool = True):
        """exchange() + borders() + neighbor build + history remap.

        ``fold=False`` (init/restore only): the durable [N, K] hist is
        already authoritative (zeros on a fresh start, seeded springs on
        a restart) and the pair list is empty, so folding would wipe it.
        """
        idx = jax.lax.axis_index("x")
        x, image = neighbor.wrap_positions(
            state.x, state.image, state.box_lo, state.box_hi, self.periodic,
            tilt=self._tilt(state),
        )
        state = state.replace(x=x, image=image)
        # Fold live pair-space springs back into the tag-keyed [N, K]
        # layout FIRST: migration ships [N, K] rows, and remap reads them.
        if fold:
            neigh = neigh.replace(hist=contact.pair_hist_to_dense(neigh))
        fracs = ghosts.fracs
        state, neigh, mig_ovf = self._migrate(state, neigh, fracs)

        send_idx, send_mask, halo_ovf = self._halo_membership(state, fracs)
        gfields = self._gather_send(state, send_idx, send_mask)
        gmeta = {}
        for f in ("scale", "shtype", "tag"):
            vals = getattr(state, f)[send_idx]
            fr = self._ring_shift(vals[: self.halo_cap], "left")
            fl = self._ring_shift(vals[self.halo_cap:], "right")
            gmeta[f] = jnp.concatenate([fl, fr], axis=0)
        # I receive: from LEFT neighbor's right-send, from RIGHT's left-send.
        g_active = jnp.concatenate([
            self._ring_shift(send_mask[self.halo_cap:], "right"),
            self._ring_shift(send_mask[: self.halo_cap], "left"),
        ])
        ghosts = GhostPack(
            x=gfields["x"], v=gfields["v"], q=gfields["q"],
            angmom=gfields["angmom"], scale=gmeta["scale"],
            shtype=gmeta["shtype"], tag=gmeta["tag"], active=g_active,
            send_idx=send_idx, send_mask=send_mask, fracs=fracs,
        )

        ext = self._extend(state, ghosts)
        slab_lo, slab_hi = self._slab_edges(state, idx, fracs)
        bin_lo = jnp.stack([
            slab_lo - self.halo_depth, state.box_lo[1], state.box_lo[2]
        ])
        bin_hi = jnp.stack([
            slab_hi + self.halo_depth,
            state.box_hi[1], state.box_hi[2],
        ])
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
                axes=self._axes,
                tilt=self._tilt(state),
            )
            neigh = neigh.replace(budget=budget)
        # Per-source gating: each count contributes only past its OWN
        # capacity, so nonzero overflow always means truncated physics.
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

    def _forward_comm(self, state: State, neigh: NeighborState,
                      ghosts: GhostPack):
        g = self._gather_send(state, ghosts.send_idx, ghosts.send_mask)
        return state, neigh, ghosts.replace(
            x=g["x"], v=g["v"], q=g["q"], angmom=g["angmom"]
        )

    def _forces(self, state: State, neigh: NeighborState, ghosts: GhostPack):
        ext = self._extend(state, ghosts)
        f, tau, pair_hist, pe_pair, virial = (
            contact.contact_force_pairs(
                ext, self.shapes, self.params, neigh,
                exact=self.exact_eval,
                periodic=self.periodic_eff, chunk=self.pair_chunk,
                tilt=self._tilt(state),
                conservative=self.conservative,
            )
        )
        neigh = neigh.replace(pair_hist=pair_hist)
        # Reactions onto ghost rows are intentionally dropped here: those
        # pairs are one-sided (pair_both=False); the ghost's owner shard
        # evaluates its own copy (Newton-off, SURVEY.md 3.5).
        f = f[: self.cap_local]
        tau = tau[: self.cap_local]

        pe_wall = jnp.zeros((), f.dtype)
        wall_hists = []
        for w_i, wall in enumerate(self.walls):
            wf, wt, whist, wpe, n_near = walls_mod.wall_contact(
                state, self.shapes, self.params, wall,
                neigh.wall_hist[: self.cap_local, w_i],
                wall_cap=self.wall_capacity,
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
            wh = jnp.stack(wall_hists, axis=1)
            neigh = neigh.replace(
                wall_hist=neigh.wall_hist.at[: self.cap_local].set(wh)
            )
        m = self.shapes.mass_of(state.shtype, state.scale)
        f = f + jnp.where(
            state.active[:, None], m[:, None] * self.params.gravity[None, :], 0.0
        )
        state = state.replace(f=f, tau=tau)
        aux = {"pe_pair": pe_pair, "pe_wall": pe_wall, "virial": virial}
        return state, neigh, aux

    def _local_step(self, state: State, neigh: NeighborState,
                    ghosts: GhostPack, rebuild: str = "check"):
        """rebuild: 'check' (pmax + lax.cond skin trigger), 'always'
        (static cadence, skin violations counted), 'comm' (forward comm
        only — the between-rebuild steps of cadence mode)."""
        state = integrate.initial_integrate(state, self.shapes, self.params)
        state, x_build, _ = integrate.apply_deformation(
            state, neigh.x_build, self.params, self.periodic
        )
        neigh = neigh.replace(x_build=x_build)
        if self.triclinic:
            # Non-flippable tilt beyond the minimum-image bound: loud
            # failure via the overflow channel (sentinel 1<<21).
            L = state.box_hi - state.box_lo
            bound = 0.5 * jnp.stack([L[0], L[0], L[1]])
            bad = jnp.any(jnp.abs(state.tilt) > bound * (1 + 1e-6))
            neigh = neigh.replace(overflow=jnp.maximum(
                neigh.overflow, jnp.where(bad, jnp.int32(1 << 21), 0)
            ))
        if rebuild == "check":
            need = self._stale(state, neigh)
            state, neigh, ghosts = jax.lax.cond(
                need,
                lambda args: self._rebuild(*args),
                lambda args: self._forward_comm(*args),
                (state, neigh, ghosts),
            )
        elif rebuild == "always":
            viol = self._stale(state, neigh).astype(jnp.int32)
            state, neigh, ghosts = self._rebuild(state, neigh, ghosts)
            neigh = neigh.replace(
                skin_violations=neigh.skin_violations + viol
            )
        else:
            state, neigh, ghosts = self._forward_comm(state, neigh, ghosts)
        state, neigh, aux = self._forces(state, neigh, ghosts)
        state = integrate.final_integrate(state, self.shapes, self.params)
        return state, neigh, ghosts, aux

    # -- public jitted entry points -----------------------------------------

    def init(self, state_global: State, restart: dict | None = None):
        """Distribute + first rebuild (Verlet::setup analogue).

        Pass ``restart`` (from :meth:`gather_restart`) to resume a run
        with contact history intact across an arbitrary re-sharding.
        """
        state, neigh, ghosts = self.distribute(state_global, restart=restart)
        return _init_jit(self, state, neigh, ghosts)

    def gather_restart(self, state, neigh):
        """Host-side restart payload: dense global State + tag-keyed
        contact history (live pair springs folded in). The returned
        dict's arrays align row-for-row with the returned State and
        round-trip through io.restart's extra fields."""
        neigh = _fold_hist_jit(self, neigh)
        st = jax.device_get(state)
        ng = jax.device_get(neigh)
        cl, ce = self.cap_local, self.cap_ext
        act = np.asarray(st.active)
        sel = np.flatnonzero(act)                 # into [P*cap_local]
        blk = sel // cl
        nrow = blk * ce + (sel - blk * cl)        # matching ext rows
        dtype = st.x.dtype

        def take(f):
            return jnp.asarray(np.asarray(getattr(st, f))[sel])

        n = sel.size
        gstate = State(
            x=take("x"), v=take("v"), q=take("q"), angmom=take("angmom"),
            f=jnp.zeros((n, 3), dtype), tau=jnp.zeros((n, 3), dtype),
            scale=take("scale"), shtype=take("shtype"), tag=take("tag"),
            active=jnp.ones((n,), bool), image=take("image"),
            box_lo=jnp.asarray(st.box_lo), box_hi=jnp.asarray(st.box_hi),
            tilt=jnp.asarray(st.tilt), step=jnp.asarray(st.step),
        )
        payload = {
            "hist_tags": np.asarray(ng.neigh_tag)[nrow],
            "hist": np.asarray(ng.hist)[nrow],
            "wall_hist": np.asarray(ng.wall_hist)[nrow],
        }
        return gstate, payload

    def run(self, state, neigh, ghosts, n_steps: int):
        return _run_jit(self, state, neigh, ghosts, n_steps)

    def rebalance(self, state, neigh, ghosts):
        """In-run load rebalance — the LAMMPS ``fix balance`` / ``balance
        x weighted`` analogue, WITHOUT a recompile: the slab bounds are
        a traced GhostPack leaf, so this swaps the array and forces one
        rebuild (migrate + re-halo + fresh forces) through the already-
        compiled program.

        New bounds are per-shard x-quantiles of the current particles,
        clamped so (a) each boundary stays strictly inside its old
        neighboring boundaries — every particle's owner moves at most
        one shard, which the +/-1-hop migration ring routes in the one
        forced rebuild — and (b) each slab stays halo-legal AND wide
        enough that the static bin grid keeps cells >= cutoff (both
        violations would otherwise flag loudly via the overflow
        channel). Call between run() blocks at the balance cadence.
        Returns (state, neigh, ghosts).
        """
        xs = np.asarray(jax.device_get(state.x))
        act = np.asarray(jax.device_get(state.active))
        lo = float(np.asarray(state.box_lo)[0])
        hi = float(np.asarray(state.box_hi)[0])
        Lx = hi - lo
        xf = np.clip((xs[act, 0] - lo) / Lx, 0.0, 1.0)
        S = self.n_shards
        cutoff_total = float(self.params.cutoff + self.params.skin) \
            + self.tilt_pad
        # Bin-grid legality floor: init sized grid_dims for the most-
        # compressed box (deform_min divided in, halo.py init), so the
        # narrowest legal window must divide it back out — otherwise a
        # rebalance during/after compression can shrink cells below
        # cutoff+skin and the 27-stencil silently misses neighbors.
        min_w = max(self.halo_depth,
                    self.grid_dims[0] * cutoff_total / self.deform_min
                    - 2 * self.halo_depth)
        min_frac = min_w / Lx * (1.0 + 1e-3)
        old = np.asarray(jax.device_get(ghosts.fracs), np.float64)
        qs = clamped_quantile_fracs(xf, old, S, min_frac)
        ghosts = ghosts.replace(
            fracs=jnp.asarray(qs, ghosts.fracs.dtype)
        )
        return _rebalance_jit(self, state, neigh, ghosts)

    def thermo(self, state, neigh, ghosts) -> dict:
        return _thermo_jit(self, state, neigh, ghosts)

    def gather_global(self, state) -> State:
        """Collect the sharded state into one host-side State (dump/restart)."""
        return jax.tree.map(lambda a: jax.device_get(a), state)

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


@partial(jax.jit, static_argnames=("sim",))
def _fold_hist_jit(sim: ShardedSimulation, neigh):
    """Fold live pair-space springs into the durable [N, K] layout."""
    def body(neigh):
        return neigh.replace(hist=contact.pair_hist_to_dense(neigh))

    return jax.shard_map(
        body, mesh=sim.mesh,
        in_specs=sim._specs((neigh,)),
        out_specs=sim._specs((neigh,))[0],
        check_vma=False,
    )(neigh)


@partial(jax.jit, static_argnames=("sim",))
def _rebalance_jit(sim: ShardedSimulation, state, neigh, ghosts):
    """One forced rebuild + force refresh after a bounds swap (compiled
    once; reused for every later rebalance — fracs is a traced leaf)."""
    def body(state, neigh, ghosts):
        state, neigh, ghosts = sim._rebuild(state, neigh, ghosts, fold=True)
        # Refresh f/tau only: the previous step already advanced the
        # springs at this configuration, and the next step will advance
        # them again — letting this pass tick too would double-count a
        # dt of tangential history (see Simulation.init_neighbors).
        hist0, whist0 = neigh.pair_hist, neigh.wall_hist
        state, neigh, _ = sim._forces(state, neigh, ghosts)
        neigh = neigh.replace(pair_hist=hist0, wall_hist=whist0)
        return state, neigh, ghosts

    args = (state, neigh, ghosts)
    return jax.shard_map(
        body, mesh=sim.mesh,
        in_specs=sim._specs(args), out_specs=sim._specs(args),
        check_vma=False,
    )(*args)


@partial(jax.jit, static_argnames=("sim",))
def _init_jit(sim: ShardedSimulation, state, neigh, ghosts):
    def body(state, neigh, ghosts):
        # fold=False: at init the durable hist (zeros, or restart seed)
        # is authoritative and the pair list is still empty.
        state, neigh, ghosts = sim._rebuild(state, neigh, ghosts,
                                            fold=False)
        # Setup pass fills f(t0) but must not advance spring history —
        # the first real step integrates this same configuration (see
        # Simulation.init_neighbors).
        hist0, whist0 = neigh.pair_hist, neigh.wall_hist
        state, neigh, _ = sim._forces(state, neigh, ghosts)
        neigh = neigh.replace(pair_hist=hist0, wall_hist=whist0)
        return state, neigh, ghosts

    args = (state, neigh, ghosts)
    return jax.shard_map(
        body, mesh=sim.mesh,
        in_specs=sim._specs(args), out_specs=sim._specs(args),
        check_vma=False,
    )(*args)


@partial(jax.jit, static_argnames=("sim", "n_steps"))
def _run_jit(sim: ShardedSimulation, state, neigh, ghosts, n_steps: int):
    def body(state, neigh, ghosts):
        R = sim.rebuild_every

        def one(carry, _):
            s, n, g = carry
            s, n, g, _ = sim._local_step(s, n, g, rebuild="check")
            return (s, n, g), None

        def comm_step(carry, _):
            s, n, g = carry
            s, n, g, _ = sim._local_step(s, n, g, rebuild="comm")
            return (s, n, g), None

        def cadence_block(carry, _):
            s, n, g = carry
            s, n, g, _ = sim._local_step(s, n, g, rebuild="always")
            if R > 1:
                (s, n, g), _ = jax.lax.scan(
                    comm_step, (s, n, g), None, length=R - 1
                )
            return (s, n, g), None

        if R > 0:
            # Cadence blocks + a statically scheduled remainder (one
            # rebuild + rem-1 comm steps). Routing the remainder
            # through the check-mode path is the round-4 perf bug: the
            # prefilter motion budget (window = R) is spent by the end
            # of the last full block, so every remainder step's cond
            # fires a full rebuild (see core/simulation.py Simulation.run).
            n_blocks, rem = divmod(n_steps, R)
            if n_blocks > 0:
                (state, neigh, ghosts), _ = jax.lax.scan(
                    cadence_block, (state, neigh, ghosts), None,
                    length=n_blocks,
                )
            if rem:
                s, n, g = state, neigh, ghosts
                s, n, g, _ = sim._local_step(s, n, g, rebuild="always")
                if rem > 1:
                    (s, n, g), _ = jax.lax.scan(
                        comm_step, (s, n, g), None, length=rem - 1
                    )
                state, neigh, ghosts = s, n, g
            return state, neigh, ghosts
        (state, neigh, ghosts), _ = jax.lax.scan(
            one, (state, neigh, ghosts), None, length=n_steps
        )
        return state, neigh, ghosts

    args = (state, neigh, ghosts)
    return jax.shard_map(
        body, mesh=sim.mesh,
        in_specs=sim._specs(args), out_specs=sim._specs(args),
        check_vma=False,
    )(*args)


@partial(jax.jit, static_argnames=("sim",))
def _thermo_jit(sim: ShardedSimulation, state, neigh, ghosts):
    def body(state, neigh, ghosts):
        state, neigh, aux = sim._forces(state, neigh, ghosts)
        ke_t, ke_r = integrate.kinetic_energy(state, sim.shapes)
        m = sim.shapes.mass_of(state.shtype, state.scale)
        pe_grav = -jnp.sum(
            jnp.where(
                state.active,
                m * jnp.sum(sim.params.gravity[None, :] * state.x, axis=-1),
                0.0,
            )
        )
        kin_tensor = jnp.einsum(
            "n,na,nb->ab", jnp.where(state.active, m, 0.0), state.v, state.v,
            precision=jax.lax.Precision.HIGHEST,
        )
        scalars = {
            "n": jnp.sum(state.active.astype(jnp.int32)),
            "ke": ke_t, "erot": ke_r,
            "pe_pair": aux["pe_pair"], "pe_wall": aux["pe_wall"],
            "pe_grav": pe_grav,
        }
        scalars = {k: jax.lax.psum(v, sim._axes) for k, v in scalars.items()}
        kin_tensor = jax.lax.psum(kin_tensor, sim._axes)
        virial = jax.lax.psum(aux["virial"], sim._axes)
        vol_box = jnp.prod(state.box_hi - state.box_lo)
        stress = (kin_tensor + virial) / vol_box
        scalars["etot"] = (
            scalars["ke"] + scalars["erot"] + scalars["pe_pair"]
            + scalars["pe_wall"] + scalars["pe_grav"]
        )
        scalars["press"] = jnp.trace(stress) / 3.0
        scalars["stress"] = stress
        scalars["step"] = state.step
        scalars["neigh_overflow"] = jax.lax.pmax(neigh.overflow, sim._axes)
        return scalars

    args = (state, neigh, ghosts)
    return jax.shard_map(
        body, mesh=sim.mesh, in_specs=sim._specs(args),
        out_specs=P(), check_vma=False,
    )(*args)
