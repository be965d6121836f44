"""spherharm_tpu — a JAX DEM engine for spherical-harmonic particles.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
LAMMPS-SPHERHARM fork ("SPHERHARM Package to simulate complex shaped
granular particles"): granular particles
whose surfaces are real spherical-harmonic expansions
``r(theta, phi) = sum a_nm Y_nm(theta, phi)``, contact via Gauss-Legendre
surface quadrature, Hertz/Coulomb force + torque, quaternion rigid-body
velocity-Verlet integration, cell-list/Verlet neighbor tensors, spatial
sharding with halo exchange over a ``jax.sharding.Mesh``.

Design stance (see SURVEY.md section 7): state is one pytree; every per-step
computation is a jitted pure function over fixed-capacity masked tensors;
parallelism is slab domain decomposition expressed with ``shard_map`` +
``lax.ppermute`` instead of MPI.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Persistent compilation cache: step graphs are large (unrolled SH
# recurrences + scanned integrator), so reruns start in seconds instead
# of minutes. JAX reads JAX_COMPILATION_CACHE_DIR itself; without it the
# cache lives at a fixed path inside the checkout (a moving path never
# hits). SPHERHARM_JAX_CACHE=0 opts out.
if (_os.environ.get("SPHERHARM_JAX_CACHE", "1") != "0"
        and not _os.environ.get("JAX_COMPILATION_CACHE_DIR")):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache"),
    )
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from spherharm_tpu.core.state import State, Shapes, NeighborState, SimParams  # noqa: F401
from spherharm_tpu.core.simulation import Simulation  # noqa: F401
