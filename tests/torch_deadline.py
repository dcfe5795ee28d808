"""A deadline on every port test, so that a test that hangs fails and the run goes on.

Each ``tests/test_torch_*.py`` imports the autouse fixture::

    from tests.torch_deadline import deadline  # noqa: F401

Two stages. At ``DEADLINE_S`` a ``SIGALRM`` dumps every thread's stack and fails the
test where its main thread next runs Python: a sleep, a wait on a lock, an event or a
subprocess, a loop. A hang inside native code never returns to the interpreter (a
LAPACK call that spins), so ``GRACE_S`` later ``faulthandler.dump_traceback_later(...,
exit=True)`` dumps the stacks again and ends the worker; pytest-xdist replaces it and
sends the ended test again, with the rest of its file, to the new worker, where a
marker file for each running test (kept for the run under ``$TMPDIR``) fails it at
once. The process keeps one faulthandler timer, so do not run these files with
``-o faulthandler_timeout`` as well.

What this cannot end: a native hang in the last test of a file under ``--dist
loadfile``. xdist hands that one test to the new worker, which holds a lone last item
until the scheduler tells it to shut down, and the scheduler never does.
"""
import faulthandler
import hashlib
import os
import signal
import sys
import tempfile

import pytest

try:  # pytest's own dup of the real stderr, taken before output capture starts
    from _pytest.faulthandler import fault_handler_stderr_fd_key as _STDERR_KEY
except ImportError:  # another pytest: fall back to the process's stderr
    _STDERR_KEY = None

#: seconds a port test may run before it fails (the slowest port test takes under a
#: minute with six workers on eight CPU cores)
DEADLINE_S = 300.0
#: seconds after that before a test stuck in native code ends its worker
GRACE_S = 60.0


def _marker(nodeid: str):
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if not run:  # one process: an ended test ends the run, nothing is sent again
        return None
    folder = os.path.join(tempfile.gettempdir(), f"torch-deadline-{run}")
    os.makedirs(folder, exist_ok=True)
    return os.path.join(folder, hashlib.sha1(nodeid.encode()).hexdigest())


@pytest.fixture(autouse=True)
def deadline(request):
    nodeid = request.node.nodeid
    marker = _marker(nodeid)
    if marker is not None:
        if os.path.exists(marker):
            pytest.fail(f"{nodeid} ended its worker in an earlier attempt of this run (its deadline or a crash)")
        open(marker, "w").close()
    fd = request.config.stash.get(_STDERR_KEY, None) if _STDERR_KEY is not None else None
    out = fd if fd is not None else sys.__stderr__

    def expire(signum, frame):
        faulthandler.dump_traceback(file=out, all_threads=True)
        pytest.fail(f"{nodeid} ran past its deadline of {DEADLINE_S:.0f} s (stacks above)")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, DEADLINE_S)
    faulthandler.dump_traceback_later(DEADLINE_S + GRACE_S, exit=True, file=out)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
        faulthandler.cancel_dump_traceback_later()
        if marker is not None:
            os.remove(marker)
