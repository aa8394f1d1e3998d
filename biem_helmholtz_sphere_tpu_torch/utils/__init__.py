"""Shared utilities: the block-tensor solve, the row shift and a
wall-clock timer."""

import logging
import time
from contextlib import contextmanager

from ._compat import btensorsolve, shift_nth_row_n_steps

log = logging.getLogger(__name__)

__all__ = ["btensorsolve", "shift_nth_row_n_steps", "timed"]


@contextmanager
def timed(label, sink=None):
    """Wall-clock a block (synchronize the card inside it to time device
    work): the seconds go to sink[label] when a dict is given, and to the
    debug log."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[label] = dt
    log.debug("%s: %.4fs", label, dt)
