"""Asynchronous valuation runtime.

The JAX package's ``runtime.py``, ported unchanged in behaviour: the
equivalent of the reference Excel add-in's calculation plumbing — the only
place the reference has async execution, progress streaming and
cancellation from a front-end:

- :class:`CalcStatus` / :class:`AsyncValuation` mirror ``ExcelCalcWrapper``
  (``ExcelCalcWrapper.cs:39-102``): a cancellable background calculation with
  subscribable progress/status events.
- :class:`ObjectCache` mirrors the add-in's named-handle caching of storage
  objects and results (``MultiFactorXl.cs:87-111`` create-and-cache,
  ``SubscribeResultProperty`` reads properties off cached results).

The Excel .xll layer itself is out of scope for the library; these
primitives are what notebook/GUI/service front-ends build on instead of RTD
observables.  The valuation runs on the background thread: its kernels
launch on that thread's current CUDA stream, the first-use kernel build is
serialised by a lock (``ops/csrc``), and a cancelled run drops its device
tensors as its frames unwind.
"""
from __future__ import annotations

import enum
import threading
from typing import Any, Callable, Dict, List, Optional

from .engines.lsmc import ValuationCancelledError


class CalcStatus(enum.Enum):
    """Reference ``CalcStatus`` (Excel add-in): lifecycle of an async calc."""

    PENDING = "pending"
    RUNNING = "running"
    SUCCESS = "success"
    ERROR = "error"
    CANCELLED = "cancelled"


class AsyncValuation:
    """A cancellable valuation running on a background thread.

    The calculation callable receives ``on_progress_update`` and ``cancelled``
    keyword arguments wired to this object — every valuation entry point in
    :mod:`storage_tpu_torch` accepts both.

    Example::

        task = AsyncValuation(multi_factor_value, storage, val_date, ...,
                              num_sims=2000, basis_funcs="1 + s", ...)
        task.subscribe_progress(print)
        task.start()
        results = task.result(timeout=600)
    """

    def __init__(self, calc_fn: Callable[..., Any], *args, **kwargs):
        self._calc_fn = calc_fn
        self._args = args
        self._kwargs = dict(kwargs)
        self._status = CalcStatus.PENDING
        self._progress = 0.0
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self._cancel_event = threading.Event()
        self._done_event = threading.Event()
        self._progress_subscribers: List[Callable[[float], None]] = []
        self._status_subscribers: List[Callable[[CalcStatus], None]] = []
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    # -- subscriptions (the RTD-observable analogue, MultiFactorXl.cs:192-242) --

    def subscribe_progress(self, callback: Callable[[float], None]) -> None:
        with self._lock:
            self._progress_subscribers.append(callback)
        callback(self._progress)

    def subscribe_status(self, callback: Callable[[CalcStatus], None]) -> None:
        with self._lock:
            self._status_subscribers.append(callback)
        callback(self._status)

    # -- lifecycle -------------------------------------------------------- --

    def start(self) -> "AsyncValuation":
        if self._thread is not None:
            raise RuntimeError("Calculation already started.")
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._set_status(CalcStatus.RUNNING)
        self._thread.start()
        return self

    def cancel(self) -> None:
        """Request cooperative cancellation (reference ``CancelCommand``)."""
        self._cancel_event.set()

    def result(self, timeout: Optional[float] = None):
        """Block until completion; re-raises errors, raises on cancellation."""
        if not self._done_event.wait(timeout):
            raise TimeoutError("Valuation did not complete within the timeout.")
        if self._status == CalcStatus.ERROR:
            raise self._error
        if self._status == CalcStatus.CANCELLED:
            raise ValuationCancelledError("Storage valuation was cancelled.")
        return self._result

    @property
    def status(self) -> CalcStatus:
        return self._status

    @property
    def progress(self) -> float:
        return self._progress

    def done(self) -> bool:
        return self._done_event.is_set()

    # -- internals --------------------------------------------------------- --

    def _set_status(self, status: CalcStatus) -> None:
        self._status = status
        with self._lock:
            subscribers = list(self._status_subscribers)
        for cb in subscribers:
            cb(status)

    def _on_progress(self, value: float) -> None:
        self._progress = value
        with self._lock:
            subscribers = list(self._progress_subscribers)
        for cb in subscribers:
            cb(value)

    def _run(self) -> None:
        try:
            self._result = self._calc_fn(
                *self._args,
                on_progress_update=self._on_progress,
                cancelled=self._cancel_event.is_set,
                **self._kwargs,
            )
            self._set_status(CalcStatus.SUCCESS)
        except ValuationCancelledError:
            self._set_status(CalcStatus.CANCELLED)
        except BaseException as exc:  # noqa: BLE001 - surfaced via result()
            self._error = exc
            self._set_status(CalcStatus.ERROR)
        finally:
            self._done_event.set()


class ObjectCache:
    """Named-handle cache for storages, tasks and results.

    Reference: the Excel add-in caches built ``CmdtyStorage`` objects and
    running calculations under user-supplied names so worksheet cells can
    reference them (``MultiFactorXl.cs:87-111``, ``StorageExcelHelper``).
    """

    def __init__(self) -> None:
        self._objects: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def add(self, name: str, obj: Any, replace: bool = True) -> str:
        with self._lock:
            if not replace and name in self._objects:
                raise KeyError(f"Object named {name!r} already cached.")
            self._objects[name] = obj
        return name

    def get(self, name: str) -> Any:
        with self._lock:
            if name not in self._objects:
                raise KeyError(f"No cached object named {name!r}.")
            return self._objects[name]

    def get_property(self, name: str, prop: str) -> Any:
        """Read a property/field off a cached object (``SubscribeResultProperty``)."""
        obj = self.get(name)
        if isinstance(obj, AsyncValuation):
            obj = obj.result()
        return getattr(obj, prop)

    def remove(self, name: str) -> None:
        with self._lock:
            self._objects.pop(name, None)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._objects)


#: Process-wide default cache, like the add-in's static dictionary.
default_cache = ObjectCache()
