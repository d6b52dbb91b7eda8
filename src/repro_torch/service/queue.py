"""Thread-safe submission queue with admission control (DESIGN.md §15).

Callers submit ``(algo, root, deadline)`` and get back a
:class:`concurrent.futures.Future`; the wave scheduler drains the queue and
resolves the futures.  Admission control is a hard bound on queued depth —
a service that cannot keep up fails FAST at submission (``AdmissionError``)
instead of letting latency grow without limit, the standard open-loop
backpressure contract.  A deadline that is already unmeetable at submit
time (``deadline_s <= 0``) is likewise rejected up front: burning a lane on
a request nobody is still waiting for helps no one.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import List, Optional

# §19 vertex programs (global results — root is normalized to 0 at submit;
# kept as a literal so importing the queue never drags in torch; asserted
# against repro_torch.programs.PROGRAM_ALGOS by the test suite)
PROGRAM_ALGOS = ("pagerank", "cc", "tri", "kcore")

ALGOS = ("bfs", "closeness", "sssp", "bc") + PROGRAM_ALGOS

_UNSET = object()


def resolve_future(future: Future, result=_UNSET, exception=None) -> bool:
    """Set a future's outcome, tolerating a caller's concurrent ``cancel()``
    (futures are never marked running, so cancellation can land between a
    ``done()`` check and the set — an unguarded ``InvalidStateError`` would
    kill the scheduler thread).  Returns True iff the outcome was set."""
    try:
        if exception is not None:
            future.set_exception(exception)
        elif result is not _UNSET:
            future.set_result(result)
        else:  # pragma: no cover
            raise TypeError("resolve_future needs a result or an exception")
        return True
    except InvalidStateError:
        return False


class AdmissionError(RuntimeError):
    """Request refused at submission (queue full / quota / unmeetable
    deadline).

    Structured so the §17 router can tell shed-and-retry-later from
    reject-permanently without parsing the message:

    * ``occupancy`` — the load measure that tripped (queued depth,
      in-flight count, tenant usage) at rejection time;
    * ``quota`` — the bound it tripped against;
    * ``retryable`` — True for transient overload (backpressure: try
      again later), False for requests that can never be admitted as
      submitted (e.g. a deadline already unmeetable at submit time);
    * ``tenant`` — the quota bucket charged, when tenancy applies;
    * ``reason`` — a short machine-readable slug (``queue_full`` /
      ``deadline_unmeetable`` / ``overload`` / ``tenant_quota``), the
      label on the §20 ``service_admission_rejects_total`` series.
    """

    def __init__(
        self,
        message: str,
        *,
        occupancy: Optional[int] = None,
        quota: Optional[int] = None,
        retryable: bool = True,
        tenant: Optional[str] = None,
        reason: str = "unspecified",
    ):
        super().__init__(message)
        self.occupancy = occupancy
        self.quota = quota
        self.retryable = retryable
        self.tenant = tenant
        self.reason = reason


class DeadlineExceeded(TimeoutError):
    """Request's deadline passed before it could be served (load shed)."""


class ServiceStopped(RuntimeError):
    """Service shut down while the request was pending."""


@dataclasses.dataclass
class QueryRequest:
    """One pending root query.  ``deadline_t`` is absolute monotonic time
    (``None`` = best-effort, never expires).  ``trace_id`` correlates the
    request's §18 spans across the stack (empty = untraced); ``drain_t``
    is stamped by the scheduler when it pops the request off the queue —
    the queue-wait / coalesce-linger boundary."""

    algo: str
    root: int
    future: Future
    submit_t: float
    deadline_t: Optional[float]
    seq: int
    trace_id: str = ""
    drain_t: float = 0.0

    def expired(self, now: float) -> bool:
        return self.deadline_t is not None and now >= self.deadline_t


class SubmissionQueue:
    """Bounded thread-safe FIFO between callers and the wave scheduler."""

    def __init__(self, max_pending: int = 1024):
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.max_pending = max_pending
        self._cond = threading.Condition()
        self._items: List[QueryRequest] = []
        self._seq = 0
        self._closed = False

    def submit(
        self,
        algo: str,
        root: int,
        deadline_s: Optional[float] = None,
        *,
        now: Optional[float] = None,
        trace_id: str = "",
    ) -> QueryRequest:
        """Enqueue and wake the scheduler; raises :class:`AdmissionError`
        on overload/unmeetable deadline, :class:`ServiceStopped` after
        :meth:`close`."""
        if algo not in ALGOS:
            raise ValueError(f"unknown algo {algo!r}; expected one of {ALGOS}")
        now = time.monotonic() if now is None else now
        if deadline_s is not None and deadline_s <= 0:
            raise AdmissionError(
                f"deadline_s={deadline_s} is unmeetable at submission",
                occupancy=len(self), quota=self.max_pending,
                retryable=False,  # resubmitting the same deadline is futile
                reason="deadline_unmeetable",
            )
        with self._cond:
            if self._closed:
                raise ServiceStopped("submission queue is closed")
            if len(self._items) >= self.max_pending:
                raise AdmissionError(
                    f"queue full ({self.max_pending} pending): overloaded",
                    occupancy=len(self._items), quota=self.max_pending,
                    retryable=True,  # backpressure: retry after a backoff
                    reason="queue_full",
                )
            req = QueryRequest(
                algo=algo,
                root=int(root),
                future=Future(),
                submit_t=now,
                deadline_t=None if deadline_s is None else now + deadline_s,
                seq=self._seq,
                trace_id=trace_id,
            )
            self._seq += 1
            self._items.append(req)
            self._cond.notify_all()
            return req

    def drain(self) -> List[QueryRequest]:
        """Pop everything currently queued (scheduler-side)."""
        with self._cond:
            items, self._items = self._items, []
            return items

    def pending(self) -> List[QueryRequest]:
        """Point-in-time copy of the queued requests WITHOUT draining —
        the §21 ops console's ``/debug/requests`` reads this."""
        with self._cond:
            return list(self._items)

    def wait(self, timeout: Optional[float]) -> bool:
        """Block until work arrives, the queue closes, or ``timeout``
        elapses; returns True iff items are queued."""
        with self._cond:
            if not self._items and not self._closed:
                self._cond.wait(timeout)
            return bool(self._items)

    def kick(self) -> None:
        """Wake any waiter without enqueuing or closing (the scheduler's
        stop path uses this so a parked thread observes its stop flag)."""
        with self._cond:
            self._cond.notify_all()

    def close(self) -> List[QueryRequest]:
        """Refuse new submissions and hand back whatever was queued so the
        caller can fail the futures."""
        with self._cond:
            self._closed = True
            items, self._items = self._items, []
            self._cond.notify_all()
            return items

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def __len__(self) -> int:
        with self._cond:
            return len(self._items)
