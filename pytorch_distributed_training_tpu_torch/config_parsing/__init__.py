"""Config loading and the logging factory.

Port of the JAX package's ``config_parsing``:

- a training config has the reference's schema (``dataset / training /
  validation / model``, ``config/ResNet50.yml:1-31``); :func:`get_cfg`
  validates the keys every run reads;
- a serving config (``serve-*.yml``) has the training schema's ``dataset``
  and ``model`` sections (so a run's model block pastes in verbatim) and a
  ``serving`` section in place of ``training``.

Missing required keys raise ``KeyError``; unknown keys are allowed (the
runner raises for the ones that ask for something not ported yet).
TensorBoard writers are ROADMAP port item P10.
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Any, Dict

import yaml

__all__ = ["get_cfg", "get_serve_cfg", "get_train_logger", "validate_cfg",
           "validate_serve_cfg"]

# every cfg[...] access of a training run (train_distributed.py:172-241)
_REQUIRED = {
    "dataset": ["name", "root", "n_classes"],
    "training": ["optimizer", "lr_schedule", "train_iters", "print_interval",
                 "val_interval", "batch_size", "num_workers", "sync_bn"],
    "model": ["name"],
}

_REQUIRED_SERVE = {
    "dataset": ["name", "n_classes"],
    "model": ["name"],
    "serving": [],
}


def validate_cfg(cfg: Dict[str, Any], path: str = "<cfg>") -> Dict[str, Any]:
    """Validate a training config; raises ``KeyError`` naming the key."""
    for section, keys in _REQUIRED.items():
        if section not in cfg:
            raise KeyError(f"{path}: missing required section '{section}'")
        for key in keys:
            if key not in cfg[section]:
                raise KeyError(f"{path}: missing required key '{section}.{key}'")
    for sub in ("optimizer", "lr_schedule"):
        if "name" not in cfg["training"][sub]:
            raise KeyError(f"{path}: missing required key 'training.{sub}.name'")
    return cfg


def get_cfg(cfg_filepath: str) -> Dict[str, Any]:
    """Load + validate a training YAML config."""
    with open(cfg_filepath, "r") as fp:
        cfg = yaml.safe_load(fp)
    return validate_cfg(cfg, cfg_filepath)


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
