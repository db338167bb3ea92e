"""Pytest hooks that keep a parallel run of the suite whole.

- A time limit for every case: `DEFAULT_LIMIT_S`, or `SLOW_LIMIT_S` for a
  case marked `slow`. Past it, an alarm on the main thread fails the case
  and the run goes on. A case stuck in native code, where the alarm's Python
  handler cannot run, gets `STACKS_AFTER_S` more: then every thread's stack
  is printed and the process ends. Under xdist that fails the case as a
  crashed worker, and a new worker takes the rest of the run; without xdist
  it ends the run. One gap stays: xdist hands the new worker one file, and
  a worker holding a single case waits for a second one before it runs it.
  If the crashed worker was the last one alive, its file had one case left
  and it had been given another file too, the run waits for the outside
  clock, as any hang did before.
- `build_runtime_once`, which the repo's root `conftest.py` calls from
  `pytest_configure`: the JAX package's runtime library is built by `make`
  in the controller, before xdist starts its workers, so that the workers
  never race the build.

The root `conftest.py` registers this module as a plugin; `-p suite_hooks`
loads it in a run without that conftest.
"""

import faulthandler
import os
import signal
import subprocess
import sys
import threading

import pytest

# Tier-1 cases must stay under 120 s of call time on the parallel run; the
# limit is 2.5x that bar, so a case that only runs slow on a loaded host
# does not fail, and one that hangs frees its worker. The `slow` cases
# compile for 270-570 s (XLA, on the CPU).
DEFAULT_LIMIT_S = 300.0
SLOW_LIMIT_S = 1200.0
STACKS_AFTER_S = 30.0
BUILD_LIMIT_S = 120.0
_STACKS_FD = pytest.StashKey[int]()


def pytest_configure(config):
    # The stacks go to the stderr the run started with: while a case runs,
    # fd 2 is pytest's capture file, which a case that never ends never shows.
    try:
        fd = sys.stderr.fileno()
    except (AttributeError, ValueError):  # xdist's worker replaces sys.stderr
        fd = sys.__stderr__.fileno()
    config.stash[_STACKS_FD] = os.dup(fd)


def pytest_unconfigure(config):
    os.close(config.stash[_STACKS_FD])


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    limit = SLOW_LIMIT_S if item.get_closest_marker("slow") else DEFAULT_LIMIT_S
    # Signals are delivered to the main thread only.
    on_main = threading.current_thread() is threading.main_thread()
    if on_main:

        def expire(signum, frame):
            pytest.fail(f"{item.nodeid} ran past its time limit of {limit:g} s")

        previous = signal.signal(signal.SIGALRM, expire)
        signal.setitimer(signal.ITIMER_REAL, limit)
    faulthandler.dump_traceback_later(limit + STACKS_AFTER_S, exit=True,
                                      file=item.config.stash[_STACKS_FD])
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()
        if on_main:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(optionalhook=True)
def pytest_handlecrashitem(crashitem, report, sched):
    # xdist's `--dist loadfile` puts every file the crashed worker was given
    # back in the queue: the case that hung, still pending, would hang each
    # new worker in turn, and a file with nothing left to run is handed to a
    # new worker as an empty batch that never reports back, so the run
    # never ends. Mark the case done and drop the finished files.
    queue = getattr(sched, "workqueue", {})
    for scope, unit in list(queue.items()):
        if crashitem in unit:
            unit[crashitem] = True
        if all(unit.values()):
            del queue[scope]


def build_runtime_once(config, runtime_dir):
    """Run `make -C runtime_dir all` in the controller process, before xdist
    starts its workers; make rebuilds the library only when it is missing or
    older than its source. An xdist worker (`config.workerinput`) never
    builds. A failed build does not stop the run: it is reported as a
    warning, and the runtime's `is_available()` then reports the library
    absent, so its tests skip."""
    if hasattr(config, "workerinput"):
        return
    try:
        done = subprocess.run(["make", "-C", runtime_dir, "all"],
                              capture_output=True, text=True, errors="replace",
                              timeout=BUILD_LIMIT_S)
    except (OSError, subprocess.TimeoutExpired) as e:  # no make; a hang
        why = str(e)
    else:
        if done.returncode == 0:
            return
        why = f"make exited {done.returncode}: {done.stderr[-2000:]}"
    config.issue_config_time_warning(
        pytest.PytestWarning(f"the runtime library in {runtime_dir} was not "
                             f"built, so its tests skip: {why}"),
        stacklevel=2)
