"""Rank-tagged logging (counterpart of ``nezha_tpu/utils/logging.py``).

Every process of a multi-process run logs through here; each line
carries the rank set at the rendezvous, so the interleaved output of a
world stays attributable.
"""

from __future__ import annotations

import logging
import os
import sys

_RANK: int = int(os.environ.get("NEZHA_RANK", "0"))
_CONFIGURED = False


def set_rank(rank: int) -> None:
    """Record this process's rank (call after ``dist.join``)."""
    global _RANK
    _RANK = int(rank)


class _RankFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        record.rank = _RANK
        return True


def get_logger(name: str = "nezha_tpu_torch") -> logging.Logger:
    """A logger whose lines go to stderr tagged ``[rank N]``. The level
    comes from ``$NEZHA_LOG_LEVEL`` (default INFO)."""
    global _CONFIGURED
    logger = logging.getLogger(name)
    if not _CONFIGURED:
        root = logging.getLogger("nezha_tpu_torch")
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s [rank %(rank)s] %(levelname)s %(name)s: "
            "%(message)s"))
        handler.addFilter(_RankFilter())
        root.addHandler(handler)
        root.setLevel(os.environ.get("NEZHA_LOG_LEVEL", "INFO").upper())
        root.propagate = False
        _CONFIGURED = True
    return logger
