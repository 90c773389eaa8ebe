"""Build the JAX package's native topology library before any test collects.

``tests/test_native.py`` skips unless ``cuddhelmholtz_tpu.native`` can load
``libcuddh_topology.so``, which that package builds with ``make`` on first
use, into one fixed path and with no lock.  Under pytest-xdist every worker
imports the test file at the same moment, so on a fresh checkout several
workers ran ``make`` into the same file at once, and a worker that loaded a
half-written library skipped the file's tests.  Building once here, in the
controller (or the single process) and never in a worker, leaves every
worker a finished library.

A failed build does not stop the other tests, but it is not a quiet skip
either: the summary names the failure with the compiler's output, and the
session exits non-zero.
"""

import os
import subprocess

NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuddhelmholtz_tpu", "native")
_BUILD_FAILURE = []


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the controller built it
        return
    try:
        proc = subprocess.run(["make", "-s", "-C", NATIVE_DIR], capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        _BUILD_FAILURE.append(f"cannot run make: {e}")
        return
    if proc.returncode != 0:
        _BUILD_FAILURE.append(f"make exited {proc.returncode}:\n{proc.stdout}{proc.stderr}")


def pytest_terminal_summary(terminalreporter):
    for msg in _BUILD_FAILURE:
        terminalreporter.write_sep("=", "native topology build failed", red=True)
        terminalreporter.write_line(f"{NATIVE_DIR}: {msg}")
        terminalreporter.write_line("tests/test_native.py skips its cases without the library")


def pytest_sessionfinish(session):
    if _BUILD_FAILURE and session.exitstatus == 0:
        session.exitstatus = 1
