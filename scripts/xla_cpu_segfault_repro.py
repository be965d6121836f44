"""Minimal repro for the late-process XLA:CPU compiler segfault.

Symptom (jaxlib 0.9.0, x86-64 linux): after many distinct programs have
been compiled in one process, compiling a further LARGE shard_map
program (observed with this repo's sharded-restart / weighted-balance
programs, and a plain big-batch shard_map suffices) can SEGFAULT inside
``backend_compile_and_load`` — the crash is in the XLA:CPU backend, not
in this package's code. The same program compiles fine early in a fresh
process, which is why tests/test_sharded.py passes standalone but a
one-process full-suite run dies ~46 test files in. The repo-level
mitigation is per-file process isolation (scripts/run_suite.py).

This script reproduces the setup deterministically: compile
``--programs`` distinct small jit programs (distinct shapes defeat both
the in-memory and persistent caches), then compile one large shard_map
program over an 8-device virtual CPU mesh. A segfault manifests as the
process dying with SIGSEGV (rc=-11 / 139) during the final phase, which
the wrapper mode detects and reports.

Usage:
  python scripts/xla_cpu_segfault_repro.py              # wrapper: runs
      the inner phase in a subprocess, reports PASS/SEGV + environment
  python scripts/xla_cpu_segfault_repro.py --inner 600  # one attempt
      with 600 warmup programs (run directly; may segfault the process)

Intermittency note: the crash is probabilistic in the number/mix of
prior compiles; 600 warmup programs reproduced within a few attempts on
this machine where ~70 real test programs sufficed. The wrapper loops
attempts until SEGV or --max-attempts.
"""

from __future__ import annotations

import os
import subprocess
import sys


def inner(n_programs: int) -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    print(f"jax {jax.__version__}, devices={len(jax.devices())}",
          flush=True)

    # Phase 1: many distinct small programs (distinct static shapes).
    for i in range(n_programs):
        n = 7 + i  # unique shape per program -> unique compile
        f = jax.jit(lambda x: jnp.tanh(x @ x.T).sum() + x[0, 0])
        f(jnp.ones((3, n))).block_until_ready()
        if (i + 1) % 100 == 0:
            print(f"  warmup compiles: {i + 1}/{n_programs}", flush=True)

    # Phase 2: one large shard_map program (the crash site).
    from jax.sharding import Mesh, PartitionSpec as P

    devs = jax.devices()
    mesh = Mesh(np.array(devs), ("x",))

    def body(a, b):
        h = a
        for _ in range(24):  # deep graph: make the compile expensive
            h = jnp.tanh(h @ b) + jax.lax.ppermute(
                h, "x", [(s, (s + 1) % len(devs)) for s in range(len(devs))]
            )
        return jax.lax.psum(h.sum(), "x"), h

    big = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("x"), P()), out_specs=(P(), P("x")),
        check_vma=False,
    ))
    a = jnp.ones((len(devs) * 64, 256))
    b = jnp.ones((256, 256))
    print("compiling large shard_map program...", flush=True)
    s, _ = big(a, b)
    jax.block_until_ready(s)
    print("inner attempt PASS (no segfault this time)", flush=True)


def main() -> int:
    if "--inner" in sys.argv:
        inner(int(sys.argv[sys.argv.index("--inner") + 1]))
        return 0

    n_programs = 600
    max_attempts = int(os.environ.get("REPRO_MAX_ATTEMPTS", "5"))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["SPHERHARM_JAX_CACHE"] = "0"  # persistent cache would skip compiles
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    for attempt in range(1, max_attempts + 1):
        print(f"=== attempt {attempt}/{max_attempts} "
              f"({n_programs} warmup programs)", flush=True)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             "--inner", str(n_programs)],
            env=env,
        )
        if proc.returncode in (-11, 139):
            print(f"=== REPRODUCED: SIGSEGV on attempt {attempt} "
                  f"(rc={proc.returncode}). XLA:CPU backend crash; "
                  "see module docstring.", flush=True)
            return 0
        if proc.returncode != 0:
            print(f"=== attempt died rc={proc.returncode} (not SIGSEGV)",
                  flush=True)
            return proc.returncode
    print("=== no segfault in "
          f"{max_attempts} attempts — intermittent; raise "
          "REPRO_MAX_ATTEMPTS or n_programs", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
