"""Cell-list / Verlet neighbor build over fixed-capacity tensors.

Fixed-shape replacement for the reference's Neighbor/NBin/NStencil/NPair
stack (SURVEY.md section 2 B.3; contract BASELINE.json:5 "the
cell-list/Verlet neighbor build ... batched ... over fixed-capacity
neighbor tensors"). LAMMPS's paged variable-length lists become a dense
``[N, K]`` index tensor + mask built with sort/scatter/top_k — static
shapes end to end, so the whole build lives inside jit (and inside
``lax.cond`` for displacement-triggered rebuilds).

Full-list semantics: pair (i, j) appears in both row i and row j; force
accumulation is then a pure per-row reduction (no scatter, Newton's third
law by antisymmetry of the pair kernel) — the scatter-free answer to LAMMPS's
newton-on reverse communication.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from spherharm_tpu.core.state import NeighborState
from spherharm_tpu.ops.contact import minimum_image, unshear_coords


@partial(jax.jit, static_argnames=("k_max",))
def allpairs_neighbors(x, active, box_lo, box_hi, cutoff, k_max: int,
                       periodic=(False, False, False), tilt=None):
    """O(N^2) neighbor build — oracle + small-system path.

    Returns (idx [N,K], mask [N,K], count [N]).
    """
    N = x.shape[0]
    d = minimum_image(x[None, :, :] - x[:, None, :], box_lo, box_hi,
                      periodic, tilt)
    dist2 = jnp.sum(d * d, axis=-1)
    eye = jnp.eye(N, dtype=bool)
    valid = (dist2 < cutoff**2) & ~eye & active[None, :] & active[:, None]
    count = jnp.sum(valid, axis=1)
    k_max = min(k_max, N)
    score = jnp.where(valid, 1.0, 0.0)
    _, idx = jax.lax.top_k(score, k_max)
    mask = jnp.take_along_axis(valid, idx, axis=1)
    return idx.astype(jnp.int32), mask, count


class CellGrid:
    """Static binning geometry: grid dims chosen once at setup.

    Cell size must stay >= cutoff+skin for the 27-stencil to be complete;
    pick dims from the *smallest* box the run will see (boxes may shrink
    under deformation; fewer cells of a larger box are always safe, but
    cells below cutoff+skin silently miss neighbors — cell_list_neighbors
    also guards this at runtime through the overflow channel).
    """

    def __init__(self, box_lo, box_hi, cutoff: float,
                 periodic=(False, False, False)):
        import numpy as np

        lo = np.asarray(box_lo, dtype=np.float64)
        hi = np.asarray(box_hi, dtype=np.float64)
        dims = np.maximum(np.floor((hi - lo) / cutoff).astype(int), 1)
        self.dims = tuple(int(v) for v in dims)
        self.n_cells = int(np.prod(dims))
        self.periodic = tuple(bool(p) for p in periodic)

    def __repr__(self):
        return f"CellGrid(dims={self.dims}, periodic={self.periodic})"


# 27-stencil offsets as a static [27, 3] table.
def _stencil_offsets():
    import numpy as np

    off = np.array(
        [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
        dtype=np.int32,
    )
    return jnp.asarray(off)


@partial(jax.jit, static_argnames=("grid_dims", "cell_cap", "k_max",
                                   "periodic", "row_chunk"))
def cell_list_neighbors(
    x, active, box_lo, box_hi, cutoff,
    grid_dims: tuple, cell_cap: int, k_max: int,
    periodic=(False, False, False),
    bin_lo=None, bin_hi=None, owned=None, tilt=None,
    row_chunk: int = 262144,
):
    """Cell-binned neighbor build. Returns (idx, mask, count, cell_overflow).

    x must already be wrapped into the box for periodic dims.
      1. bin:      cell coords via floor((x-lo)/cell), linear cell id
      2. rank:     sort by cell id; rank-in-cell = position - cell start
      3. table:    scatter ids into [n_cells * cell_cap] slots
      4. stencil:  gather 27 neighboring cells -> [N, 27*cell_cap] candidates
      5. filter:   min-image distance < cutoff, self/inactive excluded
      6. compact:  stable top_k on validity -> [N, k_max]

    Steps 4-6 materialize [N, 27*cell_cap(*3)] intermediates — the
    single-chip capacity ceiling at large N (n=1M needs ~11 GB of
    transient HBM unchunked). ``row_chunk`` bounds them by running the
    stencil/filter/top_k stage through ``lax.map`` over row blocks; the
    rebuild is off the hot path (cadence ~20), so the loop costs
    nothing that matters. 0 disables chunking.

    Sharded use (SURVEY.md 2 B.6): pass the extended local+ghost arrays,
    ``bin_lo``/``bin_hi`` covering the owned slab plus halo margin (the
    PBC box stays ``box_lo``/``box_hi``), ``owned`` marking owned rows
    (ghosts appear only as j), and periodic=False along the sharded axis
    (ghost images are explicit there).
    """
    N = x.shape[0]
    if bin_lo is None:
        bin_lo = box_lo
    if bin_hi is None:
        bin_hi = box_hi
    if owned is None:
        owned = active
    D = jnp.asarray(grid_dims, jnp.int32)
    n_cells = int(grid_dims[0] * grid_dims[1] * grid_dims[2])
    cell_sz = (bin_hi - bin_lo) / jnp.asarray(grid_dims, x.dtype)

    # Bin in the unsheared frame when the box is tilted: periodic images
    # are exact orthogonal translations there, so the 27-stencil stays
    # complete (the caller inflates the cutoff to cover the skew).
    x_bin = x if tilt is None else unshear_coords(x, box_lo, box_hi, tilt)
    cc = jnp.floor((x_bin - bin_lo) / cell_sz).astype(jnp.int32)
    cc = jnp.clip(cc, 0, D - 1)
    cid = (cc[:, 0] * D[1] + cc[:, 1]) * D[2] + cc[:, 2]
    cid = jnp.where(active, cid, n_cells)  # inactive -> overflow bin

    # Rank within cell via sort.
    order = jnp.argsort(cid)
    cid_sorted = cid[order]
    starts = jnp.searchsorted(cid_sorted, cid_sorted, side="left")
    rank_sorted = jnp.arange(N, dtype=jnp.int32) - starts.astype(jnp.int32)
    rank = jnp.zeros(N, jnp.int32).at[order].set(rank_sorted)

    # Scatter into the cell table (drop overflowing ranks / inactive bin).
    flat = jnp.where(
        (rank < cell_cap) & (cid < n_cells), cid * cell_cap + rank, n_cells * cell_cap
    )
    table = jnp.full((n_cells * cell_cap + 1,), -1, jnp.int32)
    table = table.at[flat].set(jnp.arange(N, dtype=jnp.int32), mode="drop")
    table = table[:-1].reshape(n_cells, cell_cap)

    per_cell_count = jnp.zeros((n_cells + 1,), jnp.int32).at[
        jnp.minimum(cid, n_cells)
    ].add(1)[:n_cells]
    cell_overflow = jnp.max(per_cell_count)
    # Cells narrower than the cutoff make the 27-stencil incomplete
    # (neighbors silently missed). Flag loudly via the overflow channel;
    # tolerance covers single-ULP float division noise. Dims of 1 span
    # the whole (possibly non-periodic, halo-padded) extent and cannot
    # under-reach, so they are exempt.
    dims_arr = jnp.asarray(grid_dims, jnp.int32)
    under = (cell_sz < cutoff * (1.0 - 1e-6)) & (dims_arr > 1)
    cell_overflow = jnp.where(
        jnp.any(under), jnp.int32(1 << 20), cell_overflow
    )

    # Stencil gather: neighbor cell coords with wrap/clamp per dim.
    off = _stencil_offsets()  # [27,3]
    pmask = jnp.asarray(periodic)

    def stencil_rows(args):
        cc_b, x_b, self_b, owned_b = args  # [C, ...]
        ncc = cc_b[:, None, :] + off[None, :, :]  # [C,27,3]
        wrapped = jnp.mod(ncc, D)
        oob = (ncc < 0) | (ncc >= D)
        ncc_ok = jnp.where(
            pmask[None, None, :], wrapped, jnp.clip(ncc, 0, D - 1)
        )
        invalid_cell = jnp.any(oob & ~pmask[None, None, :], axis=-1)
        ncid = ((ncc_ok[..., 0] * D[1] + ncc_ok[..., 1]) * D[2]
                + ncc_ok[..., 2])
        ncid = jnp.where(invalid_cell, n_cells - 1, ncid)  # masked below

        cand = table[ncid]  # [C, 27, cell_cap]
        cand = jnp.where(invalid_cell[..., None], -1, cand)
        cand = cand.reshape(-1, 27 * cell_cap)

        safe = jnp.maximum(cand, 0)
        d = minimum_image(
            x[safe] - x_b[:, None, :], box_lo, box_hi, periodic, tilt
        )
        dist2 = jnp.sum(d * d, axis=-1)
        valid = (
            (cand >= 0)
            & (cand != self_b[:, None])
            & (dist2 < cutoff**2)
            & active[safe]
            & owned_b[:, None]
        )
        count = jnp.sum(valid, axis=1)
        score = jnp.where(valid, 1.0, 0.0)
        _, sel = jax.lax.top_k(score, k_max)  # stable: lowest index first
        idx_b = jnp.take_along_axis(safe, sel, axis=1)
        mask_b = jnp.take_along_axis(valid, sel, axis=1)
        return idx_b.astype(jnp.int32), mask_b, count

    self_idx = jnp.arange(N, dtype=jnp.int32)
    if row_chunk and N > row_chunk:
        C = row_chunk
        nb = -(-N // C)
        pad = nb * C - N
        padr = lambda a: jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))
        args = (
            padr(cc).reshape(nb, C, 3),
            padr(x).reshape(nb, C, 3),
            # Padding rows self-match nothing real; owned=False masks
            # them out entirely.
            jnp.pad(self_idx, (0, pad), constant_values=-1)
            .reshape(nb, C),
            padr(owned.astype(bool)).reshape(nb, C),
        )
        idx, mask, count = jax.lax.map(stencil_rows, args)
        idx = idx.reshape(nb * C, k_max)[:N]
        mask = mask.reshape(nb * C, k_max)[:N]
        count = count.reshape(nb * C)[:N]
    else:
        idx, mask, count = stencil_rows((cc, x, self_idx, owned))
    return idx, mask, count, cell_overflow


@partial(jax.jit, static_argnames=("chunk",))
def remap_history(new_key, new_mask, old_key, old_mask, old_hist,
                  row_ok=None, chunk: int = 4096):
    """Carry tangential-spring state across a neighbor rebuild.

    Keys are stable per-neighbor identifiers — neighbor TAGS in general
    (slot indices shuffle under sharding/migration; tags don't). For each
    row, match new keys against old keys (masked equality join) and gather
    the old spring; unmatched (fresh) contacts start at zero. ``row_ok``
    [N] masks rows whose owner changed slots (immigrants start fresh).
    The [N, K_new, K_old] match tensor is materialized per chunk to bound
    memory (SURVEY.md 7.3 "history remap ... fiddly masked code").
    """
    N, K = new_key.shape
    if row_ok is None:
        row_ok = jnp.ones((N,), bool)

    def body(args):
        ni, nm, oi, om, oh, rk = args
        m = (
            (ni[:, :, None] == oi[:, None, :])
            & om[:, None, :]
            & nm[:, :, None]
            & rk[:, None, None]
        )
        # HIGHEST: a one-hot product must copy the springs bit-exactly
        # (TF32 would round them to ~3 digits at every rebuild).
        return jnp.einsum("nkl,nlc->nkc", m.astype(oh.dtype), oh,
                          precision=jax.lax.Precision.HIGHEST)

    if N > chunk:
        n_chunks = -(-N // chunk)
        pad = n_chunks * chunk - N
        args = (new_key, new_mask, old_key, old_mask, old_hist, row_ok)
        args = jax.tree.map(
            lambda a: jnp.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1)), args
        )
        args = jax.tree.map(
            lambda a: a.reshape((n_chunks, chunk) + a.shape[1:]), args
        )
        out = jax.lax.map(body, args)
        return out.reshape((n_chunks * chunk,) + out.shape[2:])[:N]
    return body((new_key, new_mask, old_key, old_mask, old_hist, row_ok))


def wrap_positions(x, image, box_lo, box_hi, periodic, tilt=None):
    """Wrap x into the box for periodic dims, tracking image counters.

    With triclinic ``tilt``, wrapping runs in lamda (fractional lattice)
    space: n = floor(H^-1 (x - lo)) per periodic dim, x -= H n. Whole
    lattice vectors only, so re-adding ``image @ H^T`` recovers the
    original position, and the wrapped fractional coordinate lies in
    [0, 1) — the property cell binning relies on.
    """
    L = box_hi - box_lo
    pmask = jnp.asarray(periodic, dtype=x.dtype)
    if tilt is None:
        shifts = jnp.floor((x - box_lo) / L) * pmask
        return x - shifts * L, image + shifts.astype(jnp.int32)
    xy, xz, yz = tilt[0], tilt[1], tilt[2]
    px, py, pz = x[..., 0], x[..., 1], x[..., 2]
    # Unbounded fractional coords by back-substitution through the
    # upper-triangular H = [a|b|c] (original coordinates throughout —
    # wrapping happens once, at the end, by whole lattice vectors).
    f3 = (pz - box_lo[2]) / L[2]
    f2 = (py - box_lo[1] - yz * f3) / L[1]
    f1 = (px - box_lo[0] - xy * f2 - xz * f3) / L[0]
    n3 = jnp.floor(f3) * pmask[2]
    n2 = jnp.floor(f2) * pmask[1]
    n1 = jnp.floor(f1) * pmask[0]
    px = px - n1 * L[0] - n2 * xy - n3 * xz
    py = py - n2 * L[1] - n3 * yz
    pz = pz - n3 * L[2]
    shifts = jnp.stack([n1, n2, n3], axis=-1)
    return (jnp.stack([px, py, pz], axis=-1),
            image + shifts.astype(jnp.int32))


def max_displacement2(x, x_build, active, box_lo, box_hi, periodic,
                      tilt=None):
    """Max squared displacement since the last build (skin trigger)."""
    d = minimum_image(x - x_build, box_lo, box_hi, periodic, tilt)
    d2 = jnp.sum(d * d, axis=-1)
    return jnp.max(jnp.where(active, d2, 0.0))


def surface_motion(x, x_build, q, q_build, gmax_s, active,
                   box_lo, box_hi, periodic, tilt=None):
    """Per-particle surface-motion bound since the last build.

    A particle's surface moves by at most |dx| + gmax * alpha, where
    alpha is the rotation angle since build and gmax the max tangential
    surface gradient |grad_tang r| (radial surface motion bound under
    rotation; exactly 0 for spheres, so spinning spheres contribute no
    rotation term). gmax_s: per-particle scaled gmax
    (shapes.gmax[type] * scale). Inactive rows report 0.
    """
    d = minimum_image(x - x_build, box_lo, box_hi, periodic, tilt)
    disp = jnp.sqrt(jnp.sum(d * d, axis=-1))
    qdot = jnp.abs(jnp.sum(q * q_build, axis=-1))
    # Quaternions may be unnormalized by a few ulp; clip for acos.
    alpha = 2.0 * jnp.arccos(jnp.clip(qdot, 0.0, 1.0))
    appr = disp + gmax_s * alpha
    return jnp.where(active, appr, 0.0)


def max_approach(x, x_build, q, q_build, gmax_s, active,
                 box_lo, box_hi, periodic, tilt=None):
    """Max per-particle surface motion since the last build (rotation-
    aware analogue of max displacement; see surface_motion)."""
    return jnp.max(surface_motion(x, x_build, q, q_build, gmax_s,
                                  active, box_lo, box_hi, periodic, tilt))


def approach_ratio(x, x_build, q, q_build, gmax_s, budget, active,
                   box_lo, box_hi, periodic, tilt=None):
    """Rebuild trigger for the PREFILTERED pair list: max over particles
    of (surface motion since build) / (its recorded motion budget).

    The prefilter (ops.contact.prefilter_pair_list) keeps a pair only if
    its probed surface gap is below b_i + b_j, where b_i is the motion
    budget recorded per particle at build time — so the kept list stays
    complete exactly while every particle's surface motion remains
    within its own budget. A value >= 1 means some particle exhausted
    its budget: rebuild. Resting particles get tight budgets (small
    lists); fast ones get headroom (no rebuild storm); the skin/2 cap on
    b preserves the candidate list's own Verlet guarantee.
    """
    appr = surface_motion(x, x_build, q, q_build, gmax_s, active,
                          box_lo, box_hi, periodic, tilt)
    ratio = appr / jnp.maximum(budget, 1e-30)
    return jnp.max(jnp.where(active, ratio, 0.0))
