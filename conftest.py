"""Run-wide test harness settings, loaded before ``tests/conftest.py``.

Two things keep one stuck test from stalling a whole ``pytest -n N --dist
loadfile`` run:

* JAX's CPU backend runs each computation inline, not on a dispatch thread.
  JAX 0.9.0's Pallas interpret mode deadlocks when Python dispatches the next
  op while an interpret-mode kernel's ``io_callback``s still run: the main
  thread parks in that op's ``__call__``, the callback in its own ``jnp`` op
  under ``interpret_pallas_call._update_clocks_for_device_barrier``, for good.
  Run inline, a kernel has finished when its call returns. The setting takes
  effect when the CPU client is made, so it is made here, before any test
  module or ``tests/conftest.py`` touches a device.
* Every test gets a time limit, ``TEST_LIMIT_S``, armed without a plugin.
"""

import faulthandler
import hashlib
import os
import tempfile

import jax
import pytest

jax.config.update("jax_cpu_enable_async_dispatch", False)

# faulthandler prints every thread's stack and exits the worker, since a
# deadlock in C cannot be interrupted from Python. Under pytest-xdist the
# controller reports the test as crashed and starts a replacement worker for
# the rest of its file; the marker file below makes that worker fail the test
# at once instead of running it into the limit again. Without xdist (`-n 0`)
# the exit ends the whole run. pytest's own `faulthandler_timeout` option
# shares the single faulthandler timer, so do not set it beside this limit;
# the suite's settings and its tier-1 command set none. The limit covers the
# test's setup too. Keep it at least 1.5 times the longest test: 150-221 s
# (setup included) in whole `-n 6` runs on a loaded 8-core host with a cold
# compile cache.
TEST_LIMIT_S = 360
_limit_fd = pytest.StashKey[int]()
_died_before = pytest.StashKey[bool]()


def _limit_marker(item):
    """The file a worker keeps while it runs `item`; None without xdist."""
    workerinput = getattr(item.config, "workerinput", None)
    if workerinput is None:
        return None
    name = hashlib.sha1(item.nodeid.encode()).hexdigest()
    return os.path.join(
        tempfile.gettempdir(), f"oft-limit-{workerinput['testrunuid']}-{name}"
    )


def pytest_configure(config):
    # stderr as it is now, outside a test: pytest captures fd 2 inside one
    config.stash[_limit_fd] = os.dup(2)


def pytest_unconfigure(config):
    os.close(config.stash[_limit_fd])


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    marker = _limit_marker(item)
    item.stash[_died_before] = marker is not None and os.path.exists(marker)
    if marker is not None:
        open(marker, "w").close()
    faulthandler.dump_traceback_later(
        TEST_LIMIT_S, exit=True, file=item.config.stash[_limit_fd]
    )
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        if marker is not None:
            os.remove(marker)


@pytest.hookimpl(tryfirst=True)
def pytest_runtest_setup(item):
    if item.stash[_died_before]:
        pytest.fail(
            f"an earlier worker died running it: it crashed or ran past "
            f"its {TEST_LIMIT_S} s limit",
            pytrace=False,
        )
