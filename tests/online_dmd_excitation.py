"""How well OnlineDmd identifies A from one trajectory driven by few inputs,
in the JAX package and in the port (on the CPU).

x_{k+1} = A x_k + B u_k with A = 0.9 Q (Q a random orthogonal n x n) and
q standard-normal inputs: the states stay in the span of B, AB, A^2 B, ...,
whose later directions decay like 0.9^j, so [x; u] is ill-conditioned and A
unidentifiable in most directions once n is large. The same error in both
packages shows that it is the record's, not the port's.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/online_dmd_excitation.py \
        [n q m batch]        (default 512 2 10000 64)
"""
import sys

import numpy as np


def main() -> None:
    n, q, m, batch = (int(v) for v in (sys.argv[1:5] or (512, 2, 10000, 64)))
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    import torch

    from corrla_rs_tpu.models.online_dmd import OnlineDmd as JaxOnlineDmd
    from corrla_rs_tpu_torch.models.online_dmd import OnlineDmd

    rng = np.random.default_rng(0)
    a = 0.9 * np.linalg.qr(rng.standard_normal((n, n)))[0]
    b = rng.standard_normal((n, q))
    u = rng.standard_normal((q, m))
    x = np.empty((n, m + 1))
    x[:, 0] = rng.standard_normal(n)
    for k in range(m):
        x[:, k + 1] = a @ x[:, k] + b @ u[:, k]
    torch.set_num_threads(4)
    port = OnlineDmd(n, q, device="cpu").fit_stream(x, u, batch=batch)
    ref = JaxOnlineDmd(n, q).fit_stream(jnp.asarray(x), jnp.asarray(u),
                                        batch=batch)
    print(f"n={n} q={q} pairs={m}: max |A - A_true| port "
          f"{np.abs(port.a.numpy() - a).max():.4e}, jax "
          f"{np.abs(np.asarray(ref.a) - a).max():.4e}; cond [x; u] "
          f"{np.linalg.cond(np.vstack([x[:, :-1], u])):.3e}")


if __name__ == "__main__":
    main()
