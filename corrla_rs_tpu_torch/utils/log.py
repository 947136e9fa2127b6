"""Library logging.

Copy of ``corrla_rs_tpu/utils/log.py`` under the port's own namespace: the
port logs through the standard ``logging`` module as ``corrla_rs_tpu_torch``
and returns quantitative results (acceptance ratios, rejection efficiency) as
values instead of printing them.
"""
from __future__ import annotations

import logging

__all__ = ["get_logger"]


def get_logger(name: str = "corrla_rs_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    return logger
