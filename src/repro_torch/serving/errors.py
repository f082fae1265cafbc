"""Typed serving error taxonomy (DESIGN.md §11).

A copy of ``repro.serving.errors`` (the port imports nothing of the
reference).

Every failure a caller can observe through a submitted Future (or a
rejected ``submit``) is one of these types, so clients can route on
``except`` clauses instead of string-matching messages:

* :class:`ServerOverloaded` — admission rejected: the bounded queue
  (``max_queue_rows``) is full.  Raised synchronously by ``submit``;
  the request was never enqueued.  Retry with backoff or shed load.
* :class:`RequestTimeout` — the request's deadline expired while it
  waited in the queue; it was shed *before* launch (no device work was
  wasted on it).  Also a ``TimeoutError`` for generic handlers.
* :class:`PoisonRequest` — this specific request's payload makes the
  compiled forward raise, proven by bisection: healthy co-batched
  neighbors resolved normally.  ``__cause__`` carries the original
  exception.  Retrying the same payload will fail again.
* :class:`BackendFault` — the execution backend itself failed (kernel
  launch / runtime fault, not the payload).  The server only surfaces
  it after the fallback backend (and retries) also failed; transient
  by nature, so a retry may succeed.  Also a ``RuntimeError``.

``ServingError`` is the common base: ``except ServingError`` catches
every typed failure the serving layer itself produces.
"""

from __future__ import annotations

__all__ = [
    "BackendFault",
    "PoisonRequest",
    "RequestTimeout",
    "ServerOverloaded",
    "ServingError",
]


class ServingError(Exception):
    """Base of every typed error the serving layer raises."""


class ServerOverloaded(ServingError):
    """The bounded request queue is full; the request was rejected at
    ``submit`` time and never enqueued."""


class RequestTimeout(ServingError, TimeoutError):
    """The request's deadline expired before launch; it was shed from
    the queue without touching the device."""


class PoisonRequest(ServingError):
    """Bisection isolated this request as the one that makes the
    forward raise; its co-batched neighbors resolved normally.  The
    original exception is chained as ``__cause__``."""


class BackendFault(ServingError, RuntimeError):
    """The execution backend failed (kernel launch / runtime fault);
    surfaced only after fallback and retries were exhausted."""
