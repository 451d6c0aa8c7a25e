"""Environment knobs with invalid-value fallback (port of the knob
helpers in ``llm_d_tpu.utils.config``).

A malformed value (``LLMD_MOE_GROUPED_MIN_T=banana``) degrades to the
shipped default with a warning instead of crashing the serving path.
"""

from __future__ import annotations

import logging
import os
from typing import Sequence

logger = logging.getLogger(__name__)


def env_int(name: str, default: int) -> int:
    """Integer env knob; a value that is not an int falls back to
    ``default``."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        logger.warning("%s=%r is not an int; using default %s",
                       name, raw, default)
        return default


def env_float(name: str, default: float) -> float:
    """Float env knob; a value that is not a float falls back to
    ``default``."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        logger.warning("%s=%r is not a float; using default %s",
                       name, raw, default)
        return default


def env_choice(name: str, default: str, choices: Sequence[str]) -> str:
    """Enumerated string env knob (case- and space-insensitive); an
    unknown value falls back to ``default``."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    val = raw.strip().lower()
    if val in choices:
        return val
    logger.warning("%s=%r is not one of %s; using default %r",
                   name, raw, tuple(choices), default)
    return default
