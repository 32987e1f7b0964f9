"""Device policy: which engine runs a task.

Every task with two implementations (maximal repeats, supermax, query
MEMs, seed extension) asks :func:`use_device`.  On
any accelerator backend the device programs run; on the CPU backend
the host NumPy engines run, and the device programs are tested against
them.  A caller that must run one route regardless of the backend (a
test, or a reference run beside the device run) wraps the call in
``with pinned(True):`` or ``with pinned(False):``.

Tasks with one implementation report the path they took with
:func:`note` (for example the exact lookup's window count, or its
binary-search fallback).  Inside ``with recorded() as taken:`` every
decision is appended to ``taken`` as a ``(task, route)`` pair, so a
driver can check which route each task took.
"""

from __future__ import annotations

import contextlib
import contextvars

_pin: contextvars.ContextVar[bool | None] = contextvars.ContextVar(
    "vstree_route_pin", default=None)
_taken: contextvars.ContextVar[list | None] = contextvars.ContextVar(
    "vstree_route_taken", default=None)


def note(task: str, route: str) -> None:
    """Record that ``task`` took ``route`` ("device", "host", or a
    task's own name for a slower path) when a :func:`recorded` block is
    open."""
    taken = _taken.get()
    if taken is not None:
        taken.append((task, route))


def use_device(task: str) -> bool:
    """True when ``task`` runs on the device engines: the pinned route
    if one is set, otherwise whether JAX's default backend is an
    accelerator."""
    device = _pin.get()
    if device is None:
        import jax

        device = jax.default_backend() != "cpu"
    note(task, "device" if device else "host")
    return device


@contextlib.contextmanager
def pinned(device: bool):
    """Run the enclosed calls on the device route (True) or the host
    route (False) whatever the backend."""
    token = _pin.set(bool(device))
    try:
        yield
    finally:
        _pin.reset(token)


@contextlib.contextmanager
def recorded():
    """Collect the ``(task, route)`` decisions of the enclosed calls
    into the yielded list."""
    taken: list[tuple[str, str]] = []
    token = _taken.set(taken)
    try:
        yield taken
    finally:
        _taken.reset(token)
