"""Best value Bayesian optimisation reaches on Branin, seed by seed, in the
JAX package and in the port (on the CPU), beside random search at the same
budget.

tests/test_bayes_opt.py::test_branin_beats_random_search holds one run (key
1, 10 + 18 evaluations) below 0.6 and below random search's best of 28
points. This script shows how that number moves with the key in each
package: the two packages' draws differ, so a key's run differs too.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/bayes_opt_seeds.py [--keys 6]
"""
import argparse
import math

import numpy as np

BOUNDS = [[-5.0, 10.0], [0.0, 15.0]]


def branin(x) -> float:
    x1, x2 = (float(v) for v in (x.tolist() if hasattr(x, "tolist") else x))
    b, c, t = 5.1 / (4 * math.pi ** 2), 5 / math.pi, 1 / (8 * math.pi)
    return ((x2 - b * x1 ** 2 + c * x1 - 6.0) ** 2
            + 10.0 * (1 - t) * math.cos(x1) + 10.0)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--keys", type=int, default=6)
    args = parser.parse_args()
    import jax

    jax.config.update("jax_enable_x64", True)
    import torch

    from corrla_rs_tpu.ops.bayes_opt import bayes_opt_minimize as jax_bo
    from corrla_rs_tpu_torch.ops.bayes_opt import bayes_opt_minimize as port_bo

    torch.set_num_threads(2)
    print("key  jax_best  port_best  random_best(rng key+1)")
    for key in range(args.keys):
        j = jax_bo(branin, BOUNDS, n_init=10, n_iters=18, key=key).y_best
        p = port_bo(branin, BOUNDS, n_init=10, n_iters=18, key=key,
                    device="cpu").y_best
        rng = np.random.default_rng(key + 1)
        r = min(branin(x) for x in rng.uniform([-5, 0], [10, 15], (28, 2)))
        print(f"{key}  {j:.4f}  {p:.4f}  {r:.4f}", flush=True)


if __name__ == "__main__":
    main()
