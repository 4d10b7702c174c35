"""Serving config loading and the logging factory.

Port of the serving half of the JAX package's ``config_parsing``: a
serving config (``serve-*.yml``) has the training schema's ``dataset`` and
``model`` sections (so a run's model block pastes in verbatim) and a
``serving`` section in place of ``training``.  Missing required keys raise
``KeyError``; unknown keys are allowed.
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Any, Dict

import yaml

__all__ = ["get_serve_cfg", "get_train_logger", "validate_serve_cfg"]

_REQUIRED_SERVE = {
    "dataset": ["name", "n_classes"],
    "model": ["name"],
    "serving": [],
}


def validate_serve_cfg(cfg: Dict[str, Any], path: str = "<cfg>") -> Dict[str, Any]:
    """Validate a serving config (see :mod:`..serving.engine` for keys)."""
    for section, keys in _REQUIRED_SERVE.items():
        if section not in cfg:
            raise KeyError(f"{path}: missing required section '{section}'")
        for key in keys:
            if key not in cfg[section]:
                raise KeyError(f"{path}: missing required key '{section}.{key}'")
    return cfg


def get_serve_cfg(cfg_filepath: str) -> Dict[str, Any]:
    """Load + validate a serving YAML config."""
    with open(cfg_filepath, "r") as fp:
        cfg = yaml.safe_load(fp)
    return validate_serve_cfg(cfg, cfg_filepath)


def get_train_logger(logdir: str, filename: str, mode: str = "a") -> logging.Logger:
    """Logger ``train`` with a file (``<logdir>/<filename>.log``) and a
    console handler; idempotent (repeated construction does not stack
    handlers)."""
    os.makedirs(logdir, exist_ok=True)
    logger = logging.getLogger("train")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    fh = logging.FileHandler(os.path.join(logdir, f"{filename}.log"), mode=mode)
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    ch = logging.StreamHandler(sys.stdout)
    ch.setFormatter(fmt)
    logger.addHandler(ch)
    logger.propagate = False
    return logger
