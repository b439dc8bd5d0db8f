"""Structured logger of the port's server: a copy of the JAX package's
`log.py`.

The reference prover server logs through LOG_TRACE / LOG_DEBUG / LOG_INFO
/ LOG_ERROR macros (src/fullprover.cpp of the rapidsnark fork); this is
the working equivalent: timestamped, level-gated stderr lines.

Level selection: ULTRAGROTH_LOG (trace|debug|info|error|off), default
info; TRACE sits below DEBUG.
"""
from __future__ import annotations

import logging
import os
import sys

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_LEVELS = {"trace": TRACE, "debug": logging.DEBUG, "info": logging.INFO,
           "error": logging.ERROR, "off": logging.CRITICAL + 1}


def get_logger(name: str = "ultragroth") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s [%(levelname)s] %(name)s: %(message)s"))
        logger.addHandler(h)
        logger.propagate = False
        level = os.environ.get("ULTRAGROTH_LOG", "info").lower()
        logger.setLevel(_LEVELS.get(level, logging.INFO))
    return logger


def trace(logger: logging.Logger, msg: str, *args) -> None:
    logger.log(TRACE, msg, *args)
