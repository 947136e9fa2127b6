"""Explicit random-generator plumbing.

Counterpart of ``corrla_rs_tpu/utils/prng.py``: every stochastic routine
takes a ``torch.Generator``, and a plain int seed is accepted wherever one
is. torch and JAX give different numbers from the same seed; the tests
rebuild the JAX draw and inject it (see ``ops.random_svd._draw_sketch``).
"""
from __future__ import annotations

import torch

__all__ = ["as_generator", "split_seed"]


def as_generator(seed_or_gen, device) -> torch.Generator:
    """Coerce an int seed (``None`` means 0) or a Generator to a Generator.

    A seed makes a fresh generator on ``device``; a generator is returned
    as it is and must live on ``device``'s type.
    """
    if isinstance(seed_or_gen, torch.Generator):
        if seed_or_gen.device.type != torch.device(device).type:
            raise ValueError(
                f"generator on {seed_or_gen.device}, draw on {device}"
            )
        return seed_or_gen
    seed = 0 if seed_or_gen is None else int(seed_or_gen)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def split_seed(seed_or_gen, n: int = 2, device="cpu") -> list:
    """``n`` independent child generators on ``device``.

    Counterpart of ``split_key``. The children are seeded with ``n`` 62-bit
    draws from the parent: a CPU generator made from an int seed (``None``
    means 0), or the generator passed in, which advances. A CUDA parent's
    draw is read back to the host, one synchronisation a split.
    """
    if isinstance(seed_or_gen, torch.Generator):
        parent = seed_or_gen
    else:
        parent = torch.Generator(device="cpu")
        parent.manual_seed(0 if seed_or_gen is None else int(seed_or_gen))
    seeds = torch.randint(0, 1 << 62, (int(n),), generator=parent,
                          device=parent.device).tolist()
    children = []
    for seed in seeds:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        children.append(gen)
    return children
