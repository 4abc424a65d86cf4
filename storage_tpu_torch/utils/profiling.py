"""Phase wall-clock profiling, and the spans and counters of one call.

Equivalent of the reference's ``Stopwatches`` class
(``LsmcValuation/Stopwatches.cs:33-82``): named phase timers around the LSMC
stages plus a pretty percentage-breakdown report logged at INFO at the end of
a calculation (``LsmcStorageValuation.cs:606-612``).

A :class:`Stopwatches` made with ``record=True`` (an entry point does so when
its caller passes a ``profile_sink``) also records the call's spans and
counters.  A span is a named host interval, with the span open around it as
its parent, timed on ``time.time_ns()``: the clock of the profiler's device
events, so the device work under a span is read from a trace.  Spans never
synchronise.  While the call runs, its recorder is the *active* one
(:meth:`Stopwatches.activate`, a context variable, so each thread sees its
own call's), which is how code below the entry points reaches it:
:func:`active`, :func:`host_wait` and :func:`upload`.  Without a recorder
every span site is one attribute check, and nothing is allocated, timed or
counted.
"""
from __future__ import annotations

import contextvars
import itertools
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch


class Span(NamedTuple):
    """One host interval of a call."""

    call: int  # the call's identity, shared by all of its spans
    name: str
    parent: int  # index of the enclosing span in the call's list; -1 at the top
    start_ns: int  # time.time_ns(), the device trace's clock
    end_ns: int  # -1 while the span is open


_CALLS = itertools.count(1)
_NO_SPAN = nullcontext()  # what a span site enters when nothing records


class _OpenSpan:
    """The context of one recorded span."""

    __slots__ = ("sw", "name", "index")

    def __init__(self, sw: "Stopwatches", name: str) -> None:
        self.sw, self.name = sw, name

    def __enter__(self):
        self.index = self.sw._open_span(self.name)

    def __exit__(self, *exc):
        self.sw._close_span(self.index)


class Stopwatches:
    """Named phase timers with an 'All' envelope; with ``record``, the
    call's spans and counters too.

    ``device`` is the device the timed work runs on: :meth:`synchronize`
    waits for it (``torch.cuda.synchronize``) so a phase's wall time covers
    the device work it queued, not just the launches.
    """

    #: The path simulations, the backward induction and the forward pass:
    #: what a valuation's host time outside them (``host_other_s``) leaves
    #: out of "All".
    CORE_PHASES = (
        "RegressionPriceSimulation",
        "ValuationPriceSimulation",
        "BackwardInduction",
        "ForwardSimulation",
    )
    PHASES = CORE_PHASES + ("Assembly",)

    def __init__(self, device=None, record: bool = False) -> None:
        self._elapsed: Dict[str, float] = {}
        self._started: Dict[str, float] = {}
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        #: When True, the simulation phases also synchronise the device at
        #: their ends, so attribution is genuine under asynchronous launches.
        #: Off by default: each synchronisation stalls the launch queue.
        self.sync: bool = False
        #: When True, phases and spans are recorded in :attr:`spans` and
        #: counts in :attr:`counters`, kept until the call hands them on.
        self.record = bool(record)
        self.call = next(_CALLS)
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self._open: List[int] = []  # indices of the open spans, innermost last
        self._phase_spans: Dict[str, int] = {}

    # -- spans and counters ------------------------------------------------ #

    def _open_span(self, name: str) -> int:
        parent = self._open[-1] if self._open else -1
        self.spans.append(Span(self.call, name, parent, time.time_ns(), -1))
        self._open.append(len(self.spans) - 1)
        return self._open[-1]

    def _close_span(self, index: int) -> None:
        self.spans[index] = self.spans[index]._replace(end_ns=time.time_ns())
        self._open.remove(index)

    def span(self, name: str):
        """A context that records a span ``name`` under the innermost open
        one; without ``record``, one shared context that does nothing."""
        return _OpenSpan(self, name) if self.record else _NO_SPAN

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name`` (recorded calls only)."""
        if self.record:
            self.counters[name] = self.counters.get(name, 0) + n

    def activate(self):
        """A context in which this recorder is :func:`active` (only when it
        records; otherwise nothing changes)."""
        return _activated(self) if self.record else _NO_SPAN

    # -- phases ------------------------------------------------------------ #

    def synchronize(self) -> None:
        """Wait for the work queued on ``device`` (no-op on the CPU).  An
        attribution sync of a traced run: recorded as a ``Sync`` span, not
        counted in ``host_syncs``."""
        if self.device.type == "cuda":
            with self.span("Sync"):
                torch.cuda.synchronize(self.device)

    def start(self, phase: str) -> None:
        if self.record:
            self._phase_spans[phase] = self._open_span(phase)
        self._started[phase] = time.perf_counter()

    def stop(self, phase: str) -> None:
        t0 = self._started.pop(phase, None)
        if t0 is not None:
            self._elapsed[phase] = self._elapsed.get(phase, 0.0) + time.perf_counter() - t0
        if phase in self._phase_spans:
            self._close_span(self._phase_spans.pop(phase))

    @contextmanager
    def time(self, phase: str):
        self.start(phase)
        try:
            yield
        finally:
            self.stop(phase)

    def elapsed(self, phase: str) -> float:
        return self._elapsed.get(phase, 0.0)

    def generate_profile_report(self) -> str:
        """Percentage-breakdown table like the reference's
        ``GenerateProfileReport`` (``Stopwatches.cs:55-80``)."""
        total = self.elapsed("All")
        lines: List[str] = []
        name_width = max(len(p) for p in list(self.PHASES) + ["All", "Other"])
        for phase in self.PHASES:
            secs = self.elapsed(phase)
            pct = (secs / total * 100.0) if total > 0 else 0.0
            lines.append(f"{phase.ljust(name_width)}  {secs:9.3f} s  {pct:6.2f}%")
        accounted = sum(self.elapsed(p) for p in self.PHASES)
        other = max(total - accounted, 0.0)
        pct_other = (other / total * 100.0) if total > 0 else 0.0
        lines.append(f"{'Other'.ljust(name_width)}  {other:9.3f} s  {pct_other:6.2f}%")
        lines.append(f"{'All'.ljust(name_width)}  {total:9.3f} s  100.00%")
        return "\n".join(lines)


_IDLE = Stopwatches()  # the recorder seen outside any recorded call: it records nothing
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("storage_tpu_torch_recorder",
                                                          default=_IDLE)


@contextmanager
def _activated(sw: Stopwatches):
    token = _ACTIVE.set(sw)
    try:
        yield sw
    finally:
        _ACTIVE.reset(token)


def active() -> Stopwatches:
    """The recorder of the call running in this context; outside a recorded
    call, one that records nothing."""
    return _ACTIVE.get()


def host_wait(op, *args):
    """``op(*args)``, a call after which the host has waited for the device:
    a fetch to the host, a blocking copy of a path set from host memory, an
    event wait.  Every such point of the port goes through here; in a
    recorded call it is a ``Wait`` span under the span that needed it, and
    one more ``host_syncs``.  The same sites count on the CPU, where nothing
    waits, as on a card.  Uploads of host constants do not come here: they go
    through :func:`upload`, which does not wait."""
    sw = _ACTIVE.get()
    if not sw.record:
        return op(*args)
    sw.count("host_syncs")
    with sw.span("Wait"):
        return op(*args)


def upload(array, device, dtype: torch.dtype) -> torch.Tensor:
    """``array`` (a NumPy array, a number or a host tensor) as a tensor of
    ``dtype`` on ``device``, without waiting for the device.

    On a card the host values are copied, and cast, into a new block of
    pinned memory, so a caller that changes its array afterwards cannot
    change what lands on the device; the copy to the device is then queued
    on the device's current stream (``non_blocking``), and torch's
    pinned-memory allocator keeps the block until that copy has run.  The
    host copy is NumPy's, on this thread: a torch copy of more than 32,768
    elements would wake torch's worker threads, which took milliseconds on a
    busy host.  On the CPU it is the host tensor (a NumPy array or a number
    copied, as ``torch.tensor`` does).  In a recorded call it counts one
    ``uploads`` (on the CPU too, as :func:`host_wait` counts) and opens no
    span."""
    _ACTIVE.get().count("uploads")
    device = torch.device(device)
    if device.type != "cuda":
        return (torch.as_tensor(array, dtype=dtype) if isinstance(array, torch.Tensor)
                else torch.tensor(array, dtype=dtype)).to(device)
    values = array.numpy() if isinstance(array, torch.Tensor) else array
    pinned = torch.empty(np.shape(values), dtype=dtype, pin_memory=True)
    pinned.numpy()[...] = values
    return pinned.to(device, non_blocking=True)


def self_times_ns(spans: Sequence[Span]) -> List[int]:
    """Each span's duration less the durations of its children (the spans
    of one call, as :attr:`Stopwatches.spans` lists them)."""
    out = [s.end_ns - s.start_ns for s in spans]
    for s in spans:
        if s.parent >= 0:
            out[s.parent] -= s.end_ns - s.start_ns
    return out
