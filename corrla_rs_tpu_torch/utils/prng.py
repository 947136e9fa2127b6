"""Explicit random-generator plumbing.

Counterpart of ``corrla_rs_tpu/utils/prng.py``: every stochastic routine
takes a ``torch.Generator``, and a plain int seed is accepted wherever one
is. torch and JAX give different numbers from the same seed; the tests
rebuild the JAX draw and inject it (see ``ops.random_svd._draw_sketch``).
"""
from __future__ import annotations

import torch

__all__ = ["as_generator"]


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
