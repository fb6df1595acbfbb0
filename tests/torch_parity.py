"""One guard around each package's run of a parity table.

``table_run(name)`` wraps a run of a table of programs on package
``name``, from its ``init`` to its ``shutdown``:

- On ``ray_tpu`` it turns the automatic garbage collector off for the run,
  and after it turns the collector back on and collects. The JAX
  package's runtime takes a plain lock in ``register_ref`` and
  ``_dec_ref``, and ``ObjectRef.__del__`` calls ``_dec_ref``
  (``ray_tpu/core/runtime.py:1087-1089, 1203-1204``,
  ``ray_tpu/core/object_ref.py:64-68``). A collection runs finalizers on
  whichever thread allocates, so one that starts inside ``register_ref``
  makes that thread wait on the lock it holds, and every later submit
  waits behind it.
- On ``ray_tpu_torch`` it leaves the collector as it is: the port's
  ``_RefLock`` defers such a decrement to the lock's release, and its
  tables keep it under test.
- On both it arms ``faulthandler.dump_traceback_later`` for ``seconds``,
  so that a run that hangs prints every thread's stack into the test
  log (pytest's own copy of stderr, which output capture does not take)
  long before an outer time limit kills the run. The timer is disarmed
  when the run ends; it dumps and lets the run go on.
"""

from __future__ import annotations

import contextlib
import faulthandler
import gc
import sys

# Longer than any table takes under a loaded whole-suite run, well short
# of the suite's time limit.
TABLE_SECONDS = 420.0


def log_fd() -> int:
    """The file descriptor faulthandler should write to: pytest's
    duplicate of the real stderr when a pytest fixture or test is on the
    stack (captured output never reaches the log of a run that is
    killed), else this process's stderr."""
    try:
        from _pytest.faulthandler import fault_handler_stderr_fd_key
    except ImportError:
        fault_handler_stderr_fd_key = None
    frame = sys._getframe(1)
    while frame is not None and fault_handler_stderr_fd_key is not None:
        for local in ("request", "item", "pyfuncitem"):
            config = getattr(frame.f_locals.get(local), "config", None)
            stash = getattr(config, "stash", None)
            if stash is not None and fault_handler_stderr_fd_key in stash:
                return stash[fault_handler_stderr_fd_key]
        frame = frame.f_back
    return sys.__stderr__.fileno()


@contextlib.contextmanager
def table_run(name: str, seconds: float = TABLE_SECONDS):
    """Around one run of a table on package ``name`` (module docstring)."""
    collector_off = name == "ray_tpu" and gc.isenabled()
    if collector_off:
        gc.disable()
    faulthandler.dump_traceback_later(seconds, file=log_fd())
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        if collector_off:
            gc.enable()
            gc.collect()
