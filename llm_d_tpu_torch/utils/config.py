"""Environment knobs with invalid-value fallback, and layered YAML
configuration (port of ``llm_d_tpu.utils.config``).

A malformed knob value (``LLMD_MOE_GROUPED_MIN_T=banana``) degrades to
the shipped default with a warning instead of crashing the serving path.

Config layers: a base file, then overlays (hardware, site), then the
CLI flags on top::

    python -m llm_d_tpu_torch.server.openai --config base.yaml \
        --config-overlay h100.yaml --port 9000

Dicts merge recursively and the later layer wins; scalars and lists
replace.  ``yaml`` is imported only when layers are loaded.
"""

from __future__ import annotations

import copy
import logging
import os
import sys
from typing import Any, Dict, Optional, Sequence

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


def deep_merge(base: Dict[str, Any], overlay: Dict[str, Any]) -> Dict[str, Any]:
    """Recursive merge: dicts merge, the overlay wins everything else."""
    out = copy.deepcopy(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_layers(paths: Sequence[str]) -> Dict[str, Any]:
    """Load and merge YAML config layers in order (later wins)."""
    import yaml

    merged: Dict[str, Any] = {}
    for path in paths:
        with open(path) as f:
            doc = yaml.safe_load(f) or {}
        if not isinstance(doc, dict):
            raise ValueError(f"{path}: config layer must be a mapping")
        merged = deep_merge(merged, doc)
    return merged


def apply_file_config(args, parser, merged: Dict[str, Any],
                      argv: Optional[Sequence[str]] = None) -> None:
    """Set ``args`` from the merged layers, the CLI flags still winning.

    A key ``max-num-seqs`` (or ``max_num_seqs``) names the argparse dest.
    A flag counts as given on the command line when its option string is
    in ``argv``: comparing values with defaults would let a file override
    an explicit flag that happens to equal its default."""
    argv = list(argv if argv is not None else sys.argv[1:])
    explicit = set()
    all_actions = parser._actions
    for token in argv:
        if not token.startswith("--"):
            continue
        base = token.split("=", 1)[0]
        # argparse's resolution: an exact option wins (--config is not an
        # abbreviation of --config-overlay); otherwise an unambiguous
        # prefix counts (--num-block).
        exact = {a.dest for a in all_actions if base in a.option_strings}
        if exact:
            explicit |= exact
            continue
        hits = {a.dest for a in all_actions
                for opt in a.option_strings if opt.startswith(base)}
        if len(hits) == 1:
            explicit.add(next(iter(hits)))
    defaults = {a.dest: a.default for a in parser._actions}
    for key, value in merged.items():
        dest = key.replace("-", "_")
        if dest not in defaults:
            raise ValueError(f"unknown config key {key!r}")
        if dest not in explicit:
            setattr(args, dest, value)
