"""Where the chain-sharded HMC/NUTS warmup departs from the single-device one.

Runs the chain samplers' parity target (16 chains, sigma = (0.5, 2), 100
warmup generations, seed 4; tests/test_torch_parallel_members.py) in gloo
worlds of 2 and 4 ranks on the CPU, sharded and on one device on the same
torch draws, and once more on one device with the first acceptance
statistic moved up by one ulp. Prints, for each world and sampler, the
first generation whose acceptance statistic differs and by how many ulps,
then the step size's relative departure from the single-device run at
chosen generations, sharded against nudged, and the adapted step sizes.
Last, the JAX package's own HMC on the same target (key 4, JAX's draws):
its adapted step size on one device and on meshes of 2, 4 and 8 of the
CPU's virtual devices.

    JAX_PLATFORMS=cpu python tests/warmup_divergence.py
"""
import os
import sys
import tempfile

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

GENS = (1, 5, 10, 15, 20, 25, 30, 40, 60, 99)


def main():
    import jax
    import jax.numpy as jnp

    from _torch_dist import World
    from corrla_rs_tpu.utils.prng import as_key

    jax.config.update("jax_enable_x64", True)
    x0 = np.asarray(jax.random.normal(as_key(3), (16, 2), jnp.float64))
    sig = np.array([0.5, 2.0])
    for n in (2, 4):
        world = World(n, tempfile.mkdtemp())
        try:
            for sampler in ("hmc", "nuts"):
                r = world.run("warmup_trace", x0, sig, 10, 100, 4,
                              sampler)[0]
                got, single, nudged = (r[k]["trace"] for k in
                                       ("sharded", "single", "nudged"))
                k = int(np.flatnonzero(np.any(got != single, axis=1))[0])
                ulps = abs(got[k, 1] - single[k, 1]) / np.spacing(
                    single[k, 1])
                dep = np.abs(got[:, 0] / single[:, 0] - 1.0)
                dep_n = np.abs(nudged[:, 0] / single[:, 0] - 1.0)
                print(f"world {n} {sampler}: first differing generation {k},"
                      f" acceptance statistic {ulps:.0f} ulp apart")
                print("  generation  sharded-vs-single  nudged-vs-single")
                for g in GENS:
                    print(f"  {g:10d}  {dep[g]:17.1e}  {dep_n[g]:16.1e}")
                print(f"  adapted step: sharded {r['sharded']['step']!r}, "
                      f"single {r['single']['step']!r}, nudged "
                      f"{r['nudged']['step']!r}")
        finally:
            world.close()
    from corrla_rs_tpu.ops.hmc import hmc_run
    from corrla_rs_tpu.parallel.mesh import CHAINS_AXIS, make_mesh

    sig_j = jnp.asarray(sig)

    def lnp(x):
        return -0.5 * jnp.sum((x / sig_j) ** 2)

    steps = [hmc_run(jnp.asarray(x0), lnp, n_steps=10, n_warmup=100, key=4,
                     mesh=None if n == 1 else make_mesh(
                         n, axis_name=CHAINS_AXIS)).step_size
             for n in (1, 2, 4, 8)]
    print("JAX hmc_run adapted step, 1 / 2 / 4 / 8 devices: "
          + " / ".join(repr(s) for s in steps))


if __name__ == "__main__":
    main()
