"""Preemption: SIGTERM -> emergency checkpoint -> clean exit.

Schedulers and preemptible machines send SIGTERM shortly before they evict
a job.  :func:`install_preemption_handler` turns the signal into a
:class:`Preempted` exception raised in the main thread, inside the training
loop; the loop's exception path saves an emergency checkpoint of the
epoch-start state (``ModelCheckpoint.save_emergency``) and re-raises, and
``--resume`` replays the interrupted epoch from its start.

The handler must be installed from the main thread (a CPython rule); the
CLI installs it around the whole run and restores the previous handlers.

Under the data axis the signal may reach one rank only, and a rank that
raised on its own would leave the others waiting in a collective.  There
the handler is ``deferred``: it only records the signal, each step's
metrics carry the count of ranks that recorded one
(``parallel/distributed.py:reduce_metrics``), and the loops raise
:class:`Preempted` on every rank at the same step (:func:`check_stop`).
"""

from __future__ import annotations

import signal


class Preempted(Exception):
    """Raised in the main thread when a shutdown signal arrives."""


# the signal a deferred handler recorded, or None
_requested = None


def stop_requested():
    """The signal number a deferred handler recorded, else None."""
    return _requested


def check_stop(ranks_stopping) -> None:
    """Raise :class:`Preempted` when ``ranks_stopping`` (a step's
    ``preempted`` metric: the ranks that recorded a signal) is nonzero."""
    if ranks_stopping is not None and float(ranks_stopping) > 0:
        raise Preempted(f"received signal {_requested}" if _requested
                        else "a peer rank received a shutdown signal")


def install_preemption_handler(signals=(signal.SIGTERM,),
                               deferred: bool = False) -> dict:
    """Route ``signals`` into a :class:`Preempted` exception, or, with
    ``deferred``, into a record that :func:`check_stop` acts on.  Returns
    the previous handlers, ``{signum: handler}``, for
    :func:`restore_handlers`; off the main thread nothing is installed."""
    global _requested
    _requested = None
    previous = {}

    def _handler(signum, frame):
        global _requested
        if deferred:
            _requested = signum
            return
        raise Preempted(f"received signal {signum}")

    for sig in signals:
        try:
            previous[sig] = signal.signal(sig, _handler)
        except ValueError:
            pass  # not the main thread: run unprotected rather than crash
    return previous


def restore_handlers(previous: dict) -> None:
    for sig, handler in previous.items():
        signal.signal(sig, handler)
