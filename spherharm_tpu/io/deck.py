"""LAMMPS input-deck translator — the command subset the five acceptance
configs need (SURVEY.md section 5.6: "a deck translator mapping the
command subset used by the five configs 1:1 onto the API"; contract
BASELINE.json:5 "reference input decks can be translated 1:1").

Supported commands (LAMMPS syntax; unknown commands raise):

  units lj|si|metal            # recorded; unit systems are caller-defined
  dimension 3
  boundary {p|f} {p|f} {p|f}
  atom_style spherharm
  region <id> block xlo xhi ylo yhi zlo zhi
  region <id> sphere cx cy cz R
  region <id> cylinder {x|y|z} c1 c2 R lo hi
  region <id> prism xlo xhi ylo yhi zlo zhi xy xz yz   # triclinic
  create_box <ntypes> <region-id>      # prism region -> tilted cell
  shape <type> <coeff-file>            # SPHERHARM coefficient table
  shape <type> sphere <R> | ellipsoid <a> <b> <c> | blob <seed> [rough]
  density <type> <rho>
  read_data <file>
  lattice {sc|fcc|bcc|hcp} <pitch>
  create_atoms <type> random <N> <seed> <region-id> [scale <lo> <hi>]
  create_atoms <type> region <region-id> [seed <s>] [scale <lo> <hi>]
  velocity all create <KE-per-atom> <seed> | velocity all set vx vy vz
  pair_style spherharm <kn> <kt> <gamma_n> <gamma_t> <mu> [lmax <L>]
             [rolling <k_roll> <gamma_roll> <mu_roll>]
             [conservative {on|off}]
  pair_coeff * * | pair_coeff <i> <j> <kn> <kt> <gn> <gt> <mu> [kr gr mur]
  neighbor <skin> bin
  neigh_modify every <N> check {yes|no}
  fix <id> all nve/sh
  fix <id> all gravity <g> vector <x> <y> <z>
  fix <id> all wall/gran plane <px> <py> <pz> <nx> <ny> <nz>
  fix <id> all wall/gran cylinder <ax> <ay> <az> <dx> <dy> <dz> <R> <omega>
  fix <id> all deform <rate_x> <rate_y> <rate_z> [xy <r>] [xz <r>] [yz <r>]
  fix <id> all press/berendsen <target> <tau>
  fix <id> <group> freeze
  fix <id> <group> setforce <fx|NULL> <fy|NULL> <fz|NULL>
  timestep <dt>
  thermo <every>
  dump <id> all custom <every> <file> [cols...]
  write_restart <file> | read_restart <file>
  run <N>
  variable <n> equal <expr> | loop <N> | index <v...> | string <v> | delete
  label <name> / jump SELF [<label>] / next <var>   # canonical loops
  if "<cond>" then "<cmd>"... [else "<cmd>"...]
  print "<text>"
  $x, ${name}, $(expr) substitution; equal-style expressions support
  arithmetic (^ for power), comparisons, &&/||, sqrt/exp/ln/log/abs/
  floor/ceil/PI, v_<name>, and thermo keywords (step, atoms, ke, pe,
  etotal, press, vol)

See docs/DECK.md for the full dialect description.

The executor builds Shapes/SimParams/State, constructs a Simulation and
runs it, producing thermo rows and dump files exactly where a LAMMPS run
would.
"""

from __future__ import annotations

import math
import re
import shlex

import numpy as np
import jax.numpy as jnp

from spherharm_tpu.core.simulation import Simulation
from spherharm_tpu.core.state import SimParams
from spherharm_tpu.io import data as data_io
from spherharm_tpu.io.dump import write_dump
from spherharm_tpu.io.thermo_log import ThermoLog
from spherharm_tpu.models import scenarios, shapes_library
from spherharm_tpu.ops.neighbor import CellGrid
from spherharm_tpu.ops.walls import CylinderWall, PlaneWall


class DeckError(ValueError):
    pass


class Region:
    """Geometric region (LAMMPS ``region``): membership + bounding box.

    Mirrors the reference's Region hierarchy (SURVEY.md 2 B.7) in the
    subset create_atoms/create_box need: block, sphere, cylinder, prism.
    """

    tilt = (0.0, 0.0, 0.0)

    def contains(self, x: np.ndarray) -> np.ndarray:  # [n,3] -> bool[n]
        raise NotImplementedError

    def bounds(self):
        """(lo, hi) enclosing orthogonal bounding box."""
        raise NotImplementedError


class BlockRegion(Region):
    def __init__(self, lo, hi):
        self.lo, self.hi = np.asarray(lo, float), np.asarray(hi, float)

    def contains(self, x):
        return np.all((x >= self.lo) & (x <= self.hi), axis=-1)

    def bounds(self):
        return self.lo, self.hi


class PrismRegion(BlockRegion):
    """Triclinic cell: block extents + (xy, xz, yz) tilt. Membership is
    tested in fractional coordinates of the skewed cell."""

    def __init__(self, lo, hi, tilt):
        super().__init__(lo, hi)
        self.tilt = tuple(float(t) for t in tilt)

    def contains(self, x):
        L = self.hi - self.lo
        xy, xz, yz = self.tilt
        f3 = (x[:, 2] - self.lo[2]) / L[2]
        f2 = (x[:, 1] - self.lo[1] - yz * f3) / L[1]
        f1 = (x[:, 0] - self.lo[0] - xy * f2 - xz * f3) / L[0]
        f = np.stack([f1, f2, f3], axis=1)
        return np.all((f >= 0.0) & (f <= 1.0), axis=1)

    def bounds(self):
        xy, xz, yz = self.tilt
        lo = self.lo + np.minimum([xy + xz, yz, 0], 0)
        hi = self.hi + np.maximum([xy + xz, yz, 0], 0)
        return lo, hi


class SphereRegion(Region):
    def __init__(self, center, radius):
        self.c, self.r = np.asarray(center, float), float(radius)

    def contains(self, x):
        return np.sum((x - self.c) ** 2, axis=-1) <= self.r**2

    def bounds(self):
        return self.c - self.r, self.c + self.r


class CylinderRegion(Region):
    """Axis-aligned cylinder: ``axis`` in {0,1,2}; (c1, c2) are the
    centers in the two transverse dims (LAMMPS order), lo/hi along axis."""

    def __init__(self, axis, c1, c2, radius, lo, hi):
        self.axis = int(axis)
        self.c1, self.c2, self.r = float(c1), float(c2), float(radius)
        self.alo, self.ahi = float(lo), float(hi)

    def contains(self, x):
        t = [d for d in range(3) if d != self.axis]
        d2 = (x[:, t[0]] - self.c1) ** 2 + (x[:, t[1]] - self.c2) ** 2
        a = x[:, self.axis]
        return (d2 <= self.r**2) & (a >= self.alo) & (a <= self.ahi)

    def bounds(self):
        lo, hi = np.empty(3), np.empty(3)
        t = [d for d in range(3) if d != self.axis]
        lo[t[0]], hi[t[0]] = self.c1 - self.r, self.c1 + self.r
        lo[t[1]], hi[t[1]] = self.c2 - self.r, self.c2 + self.r
        lo[self.axis], hi[self.axis] = self.alo, self.ahi
        return lo, hi


# Lattice basis points (fractions of the conventional cubic/hex cell),
# matching the reference's Lattice styles (SURVEY.md 2 B.7).
_LATTICE_BASIS = {
    "sc": np.array([[0.0, 0.0, 0.0]]),
    "bcc": np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
    "fcc": np.array([
        [0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5], [0.0, 0.5, 0.5],
    ]),
    # orthorhombic representation of hcp (c/a = sqrt(8/3)): cell
    # (a, sqrt(3) a, sqrt(8/3) a) with 4 basis atoms.
    "hcp": np.array([
        [0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
        [0.5, 5.0 / 6.0, 0.5], [0.0, 1.0 / 3.0, 0.5],
    ]),
}
_LATTICE_CELL = {
    "sc": np.array([1.0, 1.0, 1.0]),
    "bcc": np.array([1.0, 1.0, 1.0]),
    "fcc": np.array([1.0, 1.0, 1.0]),
    "hcp": np.array([1.0, np.sqrt(3.0), np.sqrt(8.0 / 3.0)]),
}


class DeckRunner:
    """Parses and executes a LAMMPS-style input deck."""

    def __init__(self, echo=False, k_max=32, cell_cap=12):
        self.echo = echo
        self.k_max = k_max
        self.cell_cap = cell_cap
        # deck state
        self.units = "lj"
        self.periodic = (False, False, False)
        self.regions = {}
        self.box = None              # (lo, hi)
        self.n_types = 1
        self.shape_specs = {}        # type(0-based) -> np coeffs
        self.density = {}
        self.lmax = None
        self.pair = None             # dict kn/kt/gn/gt/mu
        self.pair_coeffs = {}        # (i, j) 0-based -> value tuple
        self.groups = {}             # group id -> bool mask over atoms
        self.skin = None
        self.dt = 1e-4
        self.gravity = (0.0, 0.0, 0.0)
        self.deform_rate = (0.0, 0.0, 0.0)
        self.shear_rate = (0.0, 0.0, 0.0)
        self.tilt = (0.0, 0.0, 0.0)
        self.rolling = (0.0, 0.0, 0.0)
        self.press_target = 0.0
        self.press_tau = 0.0
        self.rebuild_every = 0
        self.conservative = True     # pair_style ... conservative on|off
        self.walls = []
        self.fixes = []
        self.group_fix_decls = []    # (group id, kind, values3, keep3)
        self.thermo_every = 0
        self.computes = {}           # id -> registered compute style
        self.dumps = []              # (every, path, cols)
        self.atoms = None            # dict of arrays
        self.rng = np.random.default_rng(12345)
        self.variables = {}         # name -> (style, data)
        self._lines = []
        self._skip_jump = False
        # runtime
        self.sim = None
        self.state = None
        self.neigh = None
        self.thermo_log = ThermoLog(echo=echo)
        self.total_steps = 0

    # ------------------------------------------------------------------

    def run_file(self, path):
        with open(path) as f:
            self.run_text(f.read())
        return self

    def run_text(self, text):
        """Execute a deck with a program counter (label/jump/next give
        LAMMPS-style loops; see cmd_variable)."""
        lines = [raw.split("#")[0].strip() for raw in text.splitlines()]
        self._lines = lines
        pc = 0
        while pc < len(lines):
            line = lines[pc]
            if not line:
                pc += 1
                continue
            nxt = self.execute(line)
            pc = nxt if nxt is not None else pc + 1
        return self

    def execute(self, line):
        """Run one command line. Returns a new program counter for flow
        commands (jump), else None."""
        line = self._substitute(line)
        toks = shlex.split(line)
        cmd, args = toks[0], toks[1:]
        handler = getattr(self, f"cmd_{cmd}", None)
        if handler is None:
            raise DeckError(f"unsupported deck command: {cmd!r}")
        return handler(args)

    # -- variables / control flow (the reference's Variable class + input
    # script flow: label/jump/next/if/print; SURVEY.md 2 B.1) -----------

    def _var_str(self, name):
        if name not in self.variables:
            raise DeckError(f"undefined variable {name!r}")
        style, data = self.variables[name]
        if style in ("loop", "index"):
            return str(data[1][data[0]])
        if style == "string":
            return str(data)
        return repr(self._eval_expr(data))  # equal-style

    def _substitute(self, line):
        line = re.sub(r"\$\{(\w+)\}", lambda m: self._var_str(m.group(1)),
                      line)
        line = re.sub(
            r"\$\(([^()]*)\)",
            lambda m: repr(self._eval_expr(m.group(1))), line,
        )
        return re.sub(r"\$(\w)", lambda m: self._var_str(m.group(1)), line)

    def _eval_expr(self, expr, _seen=()):
        """Evaluate a LAMMPS equal-style expression: arithmetic, ^ for
        power, comparison/boolean ops, thermo keywords, v_<name>.

        Referenced variables are resolved lazily (and cycles raise)."""
        py = expr.replace("^", "**").replace("&&", " and ").replace(
            "||", " or ")
        # Builtins are stripped below, but dunder attribute access could
        # still reach arbitrary code via `().__class__` chains — reject.
        if "__" in py:
            raise DeckError(f"illegal expression (dunder access): {expr!r}")
        env = {
            "__builtins__": {},
            "sqrt": math.sqrt, "exp": math.exp, "ln": math.log,
            "log": math.log10, "abs": abs, "floor": math.floor,
            "ceil": math.ceil, "PI": math.pi,
        }
        for name in set(re.findall(r"\bv_(\w+)\b", py)):
            if name in _seen:
                raise DeckError(f"circular variable reference {name!r}")
            if name not in self.variables:
                raise DeckError(f"undefined variable {name!r}")
            style, data = self.variables[name]
            if style in ("loop", "index"):
                val = data[1][data[0]]
                try:
                    val = float(val)
                except ValueError:
                    pass
            elif style == "string":
                val = data
            else:
                val = self._eval_expr(data, _seen + (name,))
            env[f"v_{name}"] = val
        if self.sim is not None:
            t = self.sim.thermo(self.state, self.neigh)
            env.update({
                "step": int(t["step"]), "atoms": int(t["n"]),
                "ke": float(t["ke"]), "pe": float(t["pe_pair"]),
                "etotal": float(t["etot"]), "press": float(t["press"]),
            })
            lo, hi = self.state.box_lo, self.state.box_hi
            env["vol"] = float(
                (hi[0] - lo[0]) * (hi[1] - lo[1]) * (hi[2] - lo[2])
            )
        elif self.box is not None:
            lo, hi = self.box
            env["vol"] = float(np.prod(np.asarray(hi) - np.asarray(lo)))
        try:
            out = eval(py, env)  # noqa: S307 — builtins stripped
        except Exception as e:
            raise DeckError(f"bad expression {expr!r}: {e}") from None
        if isinstance(out, bool):
            return int(out)
        return out

    def cmd_variable(self, a):
        name, style = a[0], a[1]
        if style == "delete":
            self.variables.pop(name, None)
            return
        if style == "loop":
            # Re-declaring a live loop variable is a no-op (LAMMPS
            # semantics: the canonical label/next/jump loop re-executes
            # the declaration every iteration).
            if name in self.variables and self.variables[name][0] == "loop":
                return
            vals = [str(i) for i in range(1, int(a[2]) + 1)]
            self.variables[name] = ("loop", [0, vals])
        elif style == "index":
            if name in self.variables and self.variables[name][0] == "index":
                return
            self.variables[name] = ("index", [0, list(a[2:])])
        elif style == "equal":
            self.variables[name] = ("equal", " ".join(a[2:]))
        elif style == "string":
            self.variables[name] = ("string", a[2])
        else:
            raise DeckError(f"unsupported variable style {style!r}")

    def cmd_label(self, a):
        pass  # positions are resolved by jump's scan

    def cmd_next(self, a):
        """Advance loop/index variables; on exhaustion delete them and
        arm the skip of the next jump (ends the canonical loop)."""
        for name in a:
            style, data = self.variables.get(name, (None, None))
            if style not in ("loop", "index"):
                raise DeckError(f"next on non-loop variable {name!r}")
            data[0] += 1
            if data[0] >= len(data[1]):
                del self.variables[name]
                self._skip_jump = True

    def cmd_jump(self, a):
        if self._skip_jump:
            self._skip_jump = False
            return None
        if a[0] not in ("SELF", "self"):
            raise DeckError("jump supports SELF only (single-file decks)")
        if len(a) == 1:
            return 0  # restart the deck
        target = a[1]
        for i, line in enumerate(self._lines):
            t = line.split()
            if len(t) == 2 and t[0] == "label" and t[1] == target:
                return i
        raise DeckError(f"label {target!r} not found")

    def cmd_print(self, a):
        print(" ".join(a))

    def cmd_if(self, a):
        """if "cond" then "cmd" ... [else "cmd" ...] — each quoted arg
        after then/else is a full command line."""
        cond = self._eval_expr(a[0])
        if a[1] != "then":
            raise DeckError("if requires: if <cond> then <cmds...>")
        try:
            split = a.index("else")
            thens, elses = a[2:split], a[split + 1:]
        except ValueError:
            thens, elses = a[2:], []
        for cmdline in thens if cond else elses:
            # Propagate flow-command returns (jump's new program counter)
            # so the canonical `if "..." then "jump SELF break"` loop
            # break actually breaks (LAMMPS semantics).
            nxt = self.execute(cmdline)
            if nxt is not None:
                return nxt

    # -- setup commands --------------------------------------------------

    def cmd_units(self, a):
        self.units = a[0]

    def cmd_dimension(self, a):
        if a[0] != "3":
            raise DeckError("only 3D is supported")

    def cmd_boundary(self, a):
        self.periodic = tuple(tok.startswith("p") for tok in a[:3])

    def cmd_newton(self, a):
        pass  # forces are always half-list (Newton on) in this engine

    def cmd_atom_style(self, a):
        if a[0] not in ("spherharm", "sphere"):
            raise DeckError(f"unsupported atom_style {a[0]}")

    def cmd_region(self, a):
        rid, kind = a[0], a[1]
        if kind == "block":
            v = [float(t) for t in a[2:8]]
            self.regions[rid] = BlockRegion(v[0::2], v[1::2])
        elif kind == "prism":
            v = [float(t) for t in a[2:11]]
            self.regions[rid] = PrismRegion(v[0:6:2], v[1:6:2], v[6:9])
        elif kind == "sphere":
            self.regions[rid] = SphereRegion(
                [float(t) for t in a[2:5]], float(a[5])
            )
        elif kind == "cylinder":
            axis = {"x": 0, "y": 1, "z": 2}[a[2]]
            self.regions[rid] = CylinderRegion(
                axis, float(a[3]), float(a[4]), float(a[5]),
                float(a[6]), float(a[7]),
            )
        else:
            raise DeckError(f"unsupported region style {kind!r}")

    def cmd_create_box(self, a):
        self.n_types = int(a[0])
        reg = self.regions[a[1]]
        if not isinstance(reg, BlockRegion):
            raise DeckError("create_box needs a block or prism region")
        self.box = (reg.lo, reg.hi)
        self.tilt = reg.tilt

    def cmd_shape(self, a):
        t = int(a[0]) - 1
        if a[1] == "sphere":
            spec = ("sphere", float(a[2]))
        elif a[1] == "ellipsoid":
            spec = ("ellipsoid", float(a[2]), float(a[3]), float(a[4]))
        elif a[1] == "blob":
            spec = ("blob", int(a[2]), float(a[3]) if len(a) > 3 else 0.15)
        else:
            spec = ("file", a[1])
        self.shape_specs[t] = spec

    def cmd_density(self, a):
        self.density[int(a[0]) - 1] = float(a[1])

    def cmd_read_data(self, a):
        self.atoms = data_io.read_data_file(a[0])
        self.box = (self.atoms["box_lo"], self.atoms["box_hi"])

    def cmd_lattice(self, a):
        if a[0] not in _LATTICE_BASIS:
            raise DeckError(f"unsupported lattice style {a[0]!r}")
        self.lattice_style = a[0]
        self.lattice_pitch = float(a[1])

    def cmd_create_atoms(self, a):
        t = int(a[0]) - 1
        seed = 12345
        if "seed" in a:
            seed = int(a[a.index("seed") + 1])
        rng = np.random.default_rng(seed)
        if a[1] == "random":
            n, seed, rid = int(a[2]), int(a[3]), a[4]
            rng = np.random.default_rng(seed)
            reg = self.regions[rid]
            lo, hi = reg.bounds()
            # Rejection-sample inside the region's bounding box.
            got = [np.zeros((0, 3))]
            need = n
            while need > 0:
                cand = rng.uniform(lo, hi, (max(2 * need, 64), 3))
                cand = cand[reg.contains(cand)][:need]
                if cand.size:
                    got.append(cand)
                    need -= cand.shape[0]
            x = np.concatenate(got, axis=0)
            if n == 0:
                return  # "random 0 ..." is a documented no-op placeholder
        elif a[1] == "region":
            # Fill the region with lattice sites (the LAMMPS
            # lattice + create_atoms region idiom).
            pitch = getattr(self, "lattice_pitch", None)
            if pitch is None:
                raise DeckError("create_atoms region requires a lattice")
            style = getattr(self, "lattice_style", "sc")
            reg = self.regions[a[2]]
            lo, hi = reg.bounds()
            cell = _LATTICE_CELL[style] * pitch
            basis = _LATTICE_BASIS[style]
            # Half-cell offset keeps sites off the region faces (and
            # reproduces the historical sc placement exactly).
            axes = [np.arange(lo[d] + cell[d] / 2, hi[d], cell[d])
                    for d in range(3)]
            gx, gy, gz = np.meshgrid(*axes, indexing="ij")
            corners = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)
            x = (corners[:, None, :] + basis[None, :, :] * cell).reshape(-1, 3)
            x = x[reg.contains(x) & np.all(x < hi - 1e-9, axis=1)]
            n = x.shape[0]
            if n == 0:
                raise DeckError("lattice produced no sites inside region")
            x = x + rng.uniform(-0.02, 0.02, x.shape) * pitch
        elif a[1] == "single":
            # LAMMPS `create_atoms <type> single <x> <y> <z>`.
            x = np.asarray([[float(a[2]), float(a[3]), float(a[4])]])
            n = 1
        else:
            raise DeckError(
                "create_atoms supports 'T random N seed region', "
                "'T region <id>' or 'T single x y z'"
            )
        scale = np.ones(n)
        if "scale" in a:
            i = a.index("scale")
            scale = rng.uniform(float(a[i + 1]), float(a[i + 2]), n)
        q = rng.normal(size=(n, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        new = {
            "x": x, "q": q, "scale": scale,
            "shtype": np.full(n, t, np.int32),
        }
        if self.atoms is None:
            self.atoms = new
            self.atoms["tag"] = np.arange(1, n + 1, dtype=np.int32)
        else:
            base = int(self.atoms["tag"].max())
            new["tag"] = np.arange(base + 1, base + n + 1, dtype=np.int32)
            for k in ("x", "q", "scale", "shtype", "tag"):
                self.atoms[k] = np.concatenate([self.atoms[k], new[k]])
            # An earlier `velocity` command materializes atoms["v"];
            # LAMMPS semantics give atoms created afterwards zero
            # velocity until a later velocity command touches them.
            if "v" in self.atoms:
                self.atoms["v"] = np.concatenate(
                    [self.atoms["v"], np.zeros((n, 3))]
                )

    def cmd_group(self, a):
        """``group <id> type <t1> [t2...]`` / ``group <id> region <rid>``
        — named setup-time atom selections (LAMMPS group command; used
        by velocity and other per-group setup commands)."""
        if self.atoms is None:
            raise DeckError("group before atoms exist")
        gid, mode = a[0], a[1]
        if mode == "type":
            types = {int(t) - 1 for t in a[2:]}
            mask = np.isin(self.atoms["shtype"], sorted(types))
        elif mode == "region":
            reg = self.regions[a[2]]
            mask = reg.contains(self.atoms["x"])
        else:
            raise DeckError(f"group mode {mode!r} unsupported")
        self.groups[gid] = mask

    def _group_mask(self, gid: str):
        n = self.atoms["x"].shape[0]
        if gid == "all":
            return np.ones(n, bool)
        if gid not in self.groups:
            raise DeckError(f"unknown group {gid!r}")
        mask = self.groups[gid]
        if mask.shape[0] != n:
            raise DeckError(
                f"group {gid!r} was defined before atoms were added; "
                "re-issue the group command"
            )
        return mask

    def cmd_velocity(self, a):
        if self.atoms is None:
            raise DeckError("velocity before atoms exist")
        n = self.atoms["x"].shape[0]
        sel = self._group_mask(a[0])
        if "v" not in self.atoms:
            self.atoms["v"] = np.zeros((n, 3))
        if a[1] == "set":
            self.atoms["v"] = np.where(
                sel[:, None],
                np.asarray([float(a[2]), float(a[3]), float(a[4])]),
                self.atoms["v"],
            )
        elif a[1] == "create":
            rng = np.random.default_rng(int(a[3]))
            v = rng.normal(size=(n, 3))
            v *= np.sqrt(float(a[2]) / np.mean(np.sum(v**2, -1)))
            self.atoms["v"] = np.where(sel[:, None], v, self.atoms["v"])
        else:
            raise DeckError(f"velocity mode {a[1]} unsupported")

    def cmd_pair_style(self, a):
        if a[0] not in ("spherharm", "sh", "gran/hertz/history"):
            raise DeckError(f"unsupported pair_style {a[0]}")
        self.pair = {
            "kn": float(a[1]), "kt": float(a[2]),
            "gamma_n": float(a[3]), "gamma_t": float(a[4]),
            "mu": float(a[5]),
        }
        if "lmax" in a:
            self.lmax = int(a[a.index("lmax") + 1])
        if "rolling" in a:
            i = a.index("rolling")
            self.rolling = tuple(float(v) for v in a[i + 1:i + 4])
        # ``conservative {on|off}``: opt out of the exact-gradient
        # elastic law (the framework default). Damped/driven decks —
        # most decks — don't care about secular NVE drift and the
        # geometric assembly skips the pe-vjp. See docs/PHYSICS.md
        # "conservative mode".
        if "conservative" in a:
            v = a[a.index("conservative") + 1].lower()
            if v not in ("on", "off", "yes", "no"):
                raise DeckError(f"conservative {v!r}: expected on|off")
            self.conservative = v in ("on", "yes")

    def cmd_pair_coeff(self, a):
        # ``pair_coeff i j kn kt gamma_n gamma_t mu [kr gr mur]`` sets a
        # per-type-pair material row (1-based types, LAMMPS-style; * *
        # with no values is the legacy no-op — geometry comes from
        # `shape`). Unset pairs mix geometrically at materialize time
        # (SimParams.with_pair_coeffs).
        if len(a) <= 2:
            return  # pair_coeff * * : accept (geometry via shape cmds)
        if a[0] == "*" or a[1] == "*":
            raise DeckError("pair_coeff with values needs explicit i j")
        i, j = int(a[0]) - 1, int(a[1]) - 1
        self.pair_coeffs[(i, j)] = tuple(float(v) for v in a[2:])

    def cmd_neighbor(self, a):
        self.skin = float(a[0])

    def cmd_neigh_modify(self, a):
        # "every N check no" -> static cadence; "check yes" -> triggered.
        every = 0
        if "every" in a:
            every = int(a[a.index("every") + 1])
        if "check" in a and a[a.index("check") + 1] == "yes":
            every = 0
        self.rebuild_every = every

    def cmd_fix(self, a):
        style = a[2]
        if style in ("nve/sh", "nve/spherharm", "nve"):
            self.fixes.append("nve")
        elif style == "gravity":
            g = float(a[3])
            assert a[4] == "vector"
            d = np.array([float(a[5]), float(a[6]), float(a[7])])
            d = d / np.linalg.norm(d)
            self.gravity = tuple(g * d)
        elif style == "wall/gran":
            # Optional per-wall material (LAMMPS fix wall/gran carries
            # its own coefficients): trailing
            # ``coeff kn kt gn gt mu [kr gr mur]``.
            mat = None
            if "coeff" in a:
                i = a.index("coeff")
                vals = [float(v) for v in a[i + 1:]]
                if len(vals) == 5:
                    vals += [0.0, 0.0, 0.0]
                if len(vals) != 8:
                    raise DeckError("wall coeff needs 5 or 8 values")
                mat = vals
                a = a[:i]
            if a[3] == "plane":
                self.walls.append(PlaneWall.create(
                    [float(v) for v in a[4:7]], [float(v) for v in a[7:10]],
                    mat=mat,
                ))
            elif a[3] == "cylinder":
                self.walls.append(CylinderWall.create(
                    [float(v) for v in a[4:7]], [float(v) for v in a[7:10]],
                    float(a[10]), float(a[11]) if len(a) > 11 else 0.0,
                    mat=mat,
                ))
            else:
                raise DeckError(f"wall kind {a[3]} unsupported")
        elif style == "deform":
            self.deform_rate = tuple(float(v) for v in a[3:6])
            shear = [0.0, 0.0, 0.0]
            for k, slot in (("xy", 0), ("xz", 1), ("yz", 2)):
                if k in a:
                    shear[slot] = float(a[a.index(k) + 1])
            self.shear_rate = tuple(shear)
        elif style == "press/berendsen":
            self.press_target = float(a[3])
            self.press_tau = float(a[4])
        elif style == "freeze":
            # LAMMPS `fix <id> <group> freeze` (GRANULAR): zero force
            # AND torque on the group each step, after all other forces.
            self.group_fix_decls.append(
                (a[1], "freeze", (0.0, 0.0, 0.0), (False,) * 3)
            )
        elif style == "setforce":
            # `fix <id> <group> setforce fx fy fz` with NULL components
            # left untouched (the LAMMPS convention).
            vals, keep = [], []
            for tok in a[3:6]:
                if tok.upper() == "NULL":
                    vals.append(0.0)
                    keep.append(True)
                else:
                    vals.append(float(tok))
                    keep.append(False)
            self.group_fix_decls.append(
                (a[1], "setforce", tuple(vals), tuple(keep))
            )
        else:
            raise DeckError(f"unsupported fix style {style}")

    def cmd_compute(self, a):
        """``compute <id> all <style> [args...]`` — registry lookup.

        Scalar styles are appended to every thermo row as ``c_<id>``;
        per-atom styles are evaluated on demand via
        ``runner.compute(<id>)``.
        """
        from spherharm_tpu.core import computes as computes_mod

        cid, style = a[0], a[2]
        if (style not in computes_mod.SCALAR_COMPUTES
                and style not in computes_mod.PERATOM_COMPUTES):
            raise DeckError(f"unsupported compute style {style!r}")
        self.computes[cid] = style

    def compute(self, cid: str):
        """Evaluate a deck-registered compute by id."""
        from spherharm_tpu.core import computes as computes_mod

        self._materialize()
        return computes_mod.compute(
            self.computes[cid], self.sim, self.state, self.neigh
        )

    def cmd_timestep(self, a):
        self.dt = float(a[0])

    def cmd_thermo(self, a):
        self.thermo_every = int(a[0])

    def cmd_dump(self, a):
        every, path = int(a[3]), a[4]
        cols = tuple(a[5:]) or None
        self.dumps.append([every, path, cols, False])

    # -- run --------------------------------------------------------------

    def _build_shapes(self):
        if self.lmax is None:
            self.lmax = 8 if any(
                s[0] in ("file", "blob") for s in self.shape_specs.values()
            ) else 4
        coeffs = []
        for t in range(max(self.shape_specs.keys(), default=-1) + 1):
            spec = self.shape_specs.get(t, ("sphere", 0.5))
            if spec[0] == "sphere":
                c = shapes_library.sphere_coeffs(spec[1], self.lmax)
            elif spec[0] == "ellipsoid":
                c = shapes_library.ellipsoid_coeffs(*spec[1:4], self.lmax)
            elif spec[0] == "blob":
                c = shapes_library.blob_coeffs(
                    self.lmax, seed=spec[1], roughness=spec[2]
                )
            else:
                c, file_lmax = data_io.read_coeff_file(spec[1])
                if file_lmax != self.lmax:
                    cc = np.zeros((self.lmax + 1) ** 2)
                    ncopy = min(len(c), len(cc))
                    cc[:ncopy] = c[:ncopy]
                    c = cc
            coeffs.append(c)
        dens = np.array([self.density.get(t, 1.0) for t in range(len(coeffs))])
        # Low-order surfaces get a denser cap grid: quadrature noise in the
        # overlap integrals, not basis truncation, limits their accuracy.
        cq = (12, 24) if self.lmax <= 2 else None
        return shapes_library.build_shapes(
            np.stack(coeffs), self.lmax, dens, contact_quad=cq
        )

    def _materialize(self):
        if self.sim is not None:
            return
        if self.pair is None or self.atoms is None or self.box is None:
            raise DeckError("deck must define box, atoms and pair_style before run")
        shapes = self._build_shapes()
        rmax = float(np.max(np.asarray(shapes.rmax)))
        scale_max = float(np.max(self.atoms["scale"]))
        cutoff = 2.0 * rmax * scale_max
        skin = self.skin if self.skin is not None else 0.3 * rmax
        params = SimParams.create(
            dt=self.dt, kn=self.pair["kn"], kt=self.pair["kt"],
            gamma_n=self.pair["gamma_n"], gamma_t=self.pair["gamma_t"],
            mu=self.pair["mu"], gravity=self.gravity,
            k_roll=self.rolling[0], gamma_roll=self.rolling[1],
            mu_roll=self.rolling[2],
            skin=skin, cutoff=cutoff,
            deform_rate=self.deform_rate, shear_rate=self.shear_rate,
            press_target=(self.press_target,) * 3, press_tau=self.press_tau,
        )
        if self.pair_coeffs:
            params = params.with_pair_coeffs(
                shapes.n_types, self.pair_coeffs
            )
        lo, hi = self.box
        triclinic = any(abs(t) > 0 for t in self.tilt) or any(
            abs(s) > 0 for s in self.shear_rate
        )
        state = scenarios.make_state(
            self.atoms["x"], lo, hi,
            v=self.atoms.get("v"), q=self.atoms.get("q"),
            angmom=self.atoms.get("angmom"),
            scale=self.atoms.get("scale"), shtype=self.atoms.get("shtype"),
            tilt=self.tilt if triclinic else None,
        )
        if "tag" in self.atoms:
            state = state.replace(
                tag=state.tag.at[: len(self.atoms["tag"])].set(
                    jnp.asarray(self.atoms["tag"], jnp.int32))
            )
        n = self.atoms["x"].shape[0]
        # Tilted cells: inflate the binning cutoff so the 27-stencil
        # stays complete in the unsheared frame (see ops/neighbor.py).
        cell_cutoff = (cutoff + skin) * (1.4 if triclinic else 1.0)
        grid = CellGrid(lo, hi, cell_cutoff, self.periodic)
        # Runtime group fixes: freeze/setforce membership keyed by tag
        # through a static bitmask table (groups are setup-time masks;
        # tags persist through migration/restart, so the table needs no
        # per-atom comm plumbing).
        group_fixes, group_tab = (), None
        if self.group_fix_decls:
            tags = np.asarray(self.atoms["tag"], np.int64)
            tab = np.zeros(int(tags.max()) + 1, np.int32)
            bit_of = {}
            entries = []
            for gid, kind, vals, keep in self.group_fix_decls:
                if gid not in bit_of:
                    bit_of[gid] = len(bit_of)
                    if len(bit_of) > 31:
                        raise DeckError("more than 31 runtime fix groups")
                    sel = self._group_mask(gid)
                    tab[tags[sel]] |= np.int32(1 << bit_of[gid])
                entries.append((kind, bit_of[gid], vals, keep))
            group_fixes, group_tab = tuple(entries), tab
        self.sim = Simulation(
            shapes, params, periodic=self.periodic, neighbor_mode="cell",
            grid=grid, k_max=self.k_max, cell_cap=self.cell_cap,
            walls=tuple(self.walls),
            pair_capacity=max(4 * n, 512),
            press_control=self.press_tau > 0,
            rebuild_every=self.rebuild_every,
            triclinic=triclinic,
            conservative=self.conservative,
            group_fixes=group_fixes,
            group_tab=group_tab,
        )
        self.state, self.neigh = self.sim.init_neighbors(state)

    def cmd_write_restart(self, a):
        from spherharm_tpu.io import restart as rio

        self._materialize()
        rio.write_restart(a[0], self.state, self.neigh, self.sim.params)

    def cmd_read_restart(self, a):
        """Resume from a checkpoint. The deck must still define the box,
        shapes and pair_style (geometry tables are not stored in the
        restart, matching the reference where pair_style follows
        read_restart); the checkpointed state/history replace the
        deck-constructed ones."""
        from spherharm_tpu.io import restart as rio

        state, neigh, params, _ = rio.read_restart(a[0])
        if neigh is None:
            raise DeckError(f"{a[0]} is a state-only checkpoint")
        act = np.asarray(state.active)
        self.atoms = {
            f: np.asarray(getattr(state, f))[act]
            for f in ("x", "v", "q", "angmom", "scale", "shtype", "tag")
        }
        self.box = (np.asarray(state.box_lo), np.asarray(state.box_hi))
        self._materialize()
        self.state, self.neigh = state, neigh

    def _outputs(self):
        from spherharm_tpu.core import computes as computes_mod

        step = int(self.state.step)
        if self.thermo_every and step % self.thermo_every == 0:
            row = self.sim.thermo(self.state, self.neigh)
            for cid, style in self.computes.items():
                if style in computes_mod.SCALAR_COMPUTES:
                    row[f"c_{cid}"] = float(computes_mod.compute(
                        style, self.sim, self.state, self.neigh
                    ))
            self.thermo_log.log(row)
        for d in self.dumps:
            every, path, cols, started = d
            if every and step % every == 0:
                kw = {"columns": cols} if cols else {}
                # Per-atom compute references (LAMMPS `c_<id>` columns).
                extra = {}
                for c in cols or ():
                    if c.startswith("c_"):
                        vals = self.compute(c[2:])
                        if getattr(vals, "ndim", 1) != 1:
                            raise DeckError(
                                f"dump column {c}: only scalar per-atom "
                                "computes are supported"
                            )
                        extra[c] = vals
                if extra:
                    kw["extra"] = extra
                write_dump(path, self.state, self.sim.shapes,
                           periodic=self.periodic, append=started, **kw)
                d[3] = True

    def cmd_run(self, a):
        n = int(a[0])
        self._materialize()
        cadences = [self.thermo_every] + [d[0] for d in self.dumps]
        cadences = [c for c in cadences if c > 0]
        self._outputs()
        done = 0
        while done < n:
            # Advance to the nearest step any output is scheduled at, so
            # non-commensurate cadences (thermo 100 + dump 30) each fire
            # on their own multiples, as LAMMPS does — not only at common
            # multiples.
            step = int(self.state.step)
            if cadences:
                todo = min(c - step % c for c in cadences)
            else:
                todo = n - done
            todo = min(todo, n - done)
            self.state, self.neigh = self.sim.run(self.state, self.neigh, todo)
            done += todo
            self._outputs()
        self.total_steps += n


def main(argv=None):
    """CLI: run input decks. ``python -m spherharm_tpu.io.deck FILE...``"""
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    if not args or args[0] in ("-h", "--help"):
        print("usage: python -m spherharm_tpu.io.deck [-q] <deck.in> ...")
        return 0 if args else 1
    echo = True
    if args[0] == "-q":
        echo = False
        args = args[1:]
    for path in args:
        DeckRunner(echo=echo).run_file(path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
