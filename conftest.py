"""Repository-level test setup, loaded before tests/conftest.py by every
pytest process (the xdist controller and each worker).

It builds the JAX package's native npz loader (native/libpcloader.so) once,
before any test module is collected. tests/test_native_loader.py asks for
the library when it is imported, and the JAX package builds it with
`make -C native` where it is missing. In a fresh checkout every xdist worker
collects that module at the same moment, so several makes ran at once and a
worker could load the library while another was still writing it
("file too short"): that worker's collection failed, and the run with it.
Here one process runs the make holding an exclusive lock; the others wait on
the lock and find the library built. A build that fails leaves no library,
and the module skips as it did before.

It also keeps a passing test's tmp_path only until the test ends (pytest's
`tmp_path_retention_policy = failed`). The checkpoint tests write about
10 GB into tmp_path over one run, and pytest keeps the last three runs'
directories by default, so a second run on the same disk could fill it and
fail a test that writes a checkpoint.
"""

import fcntl
import os
import subprocess

import pytest

_ROOT = os.path.dirname(os.path.abspath(__file__))
_NATIVE = os.path.join(_ROOT, "native")


def _build_native_loader():
    if os.path.exists(os.path.join(_NATIVE, "libpcloader.so")):
        return
    build = os.path.join(_ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with open(os.path.join(build, ".libpcloader.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            subprocess.run(["make", "-C", _NATIVE], check=True, capture_output=True, timeout=300)
        except (OSError, subprocess.SubprocessError):
            pass  # no library: test_native_loader.py skips, as without this file


@pytest.hookimpl(tryfirst=True)
def pytest_configure(config):
    # read by the tmpdir plugin's pytest_configure, which runs after this one
    config.inicfg.setdefault("tmp_path_retention_policy", "failed")


_build_native_loader()
