"""Preemption: SIGTERM -> emergency checkpoint -> clean exit.

Schedulers and preemptible machines send SIGTERM shortly before they evict
a job.  :func:`install_preemption_handler` turns the signal into a
:class:`Preempted` exception raised in the main thread, inside the training
loop; the loop's exception path saves an emergency checkpoint of the
epoch-start state (``ModelCheckpoint.save_emergency``) and re-raises, and
``--resume`` replays the interrupted epoch from its start.

The handler must be installed from the main thread (a CPython rule); the
CLI installs it around the whole run and restores the previous handlers.
"""

from __future__ import annotations

import signal


class Preempted(Exception):
    """Raised in the main thread when a shutdown signal arrives."""


def install_preemption_handler(signals=(signal.SIGTERM,)) -> dict:
    """Route ``signals`` into a :class:`Preempted` exception.  Returns the
    previous handlers, ``{signum: handler}``, for
    :func:`restore_handlers`; off the main thread nothing is installed."""
    previous = {}

    def _handler(signum, frame):
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
