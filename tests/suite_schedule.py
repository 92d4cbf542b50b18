"""How a run of the test suite is scheduled (``-n N --dist loadfile``): a
pytest plugin that the conftest.py at the repository's root loads for every
run under it.

- Files go to the workers longest first, by tests/file_seconds.json
  (tools/file_seconds.py writes it from a run's junit XML). Files the table
  does not know go before all others, so a new heavy file cannot become the
  tail.
- A test fails once it has run TEST_LIMIT_S seconds. An xdist worker stuck
  inside one C call, where the alarm cannot act, is ended a minute later,
  its threads' stacks written to the run's directory; xdist then fails the
  test and starts a new worker. xdist hands the test to a worker again, and
  there it fails at once, with those stacks, rather than hang once more.
"""
import contextlib
import faulthandler
import hashlib
import json
import os
import pathlib
import shutil
import signal
import tempfile

import pytest

TESTS_DIR = pathlib.Path(__file__).resolve().parent
FILE_SECONDS = TESTS_DIR / "file_seconds.json"

# 1.6x the longest test seen: 771 s, six workers on a busy 8-core CPU with
# the longest files started together and the JAX drivers' compile cache
# cold. A machine slow enough to take a test past it would not finish the
# suite inside the 1470 s it is given anyway.
TEST_LIMIT_S = 1200
_BACKSTOP_S = TEST_LIMIT_S + 60

RUN_DIR_ENV = "SUITE_RUN_DIR"
_run_dir = pytest.StashKey[str]()
_ended = pytest.StashKey[str]()


def make_run_dir():
    """A fresh directory for one run, in the temp dir: the stacks of a
    worker the backstop ended."""
    return tempfile.mkdtemp(prefix="suite-run-")


def remove_run_dir(path):
    shutil.rmtree(path, ignore_errors=True)


def longest_files_first(items, seconds):
    """`items` grouped by file, each file's items in their order: files
    missing from `seconds` first, then the others longest first, ties by
    path, so that every process orders one collection alike."""
    files = {}
    for item in items:
        files.setdefault(os.path.relpath(item.path, TESTS_DIR), []).append(item)
    order = sorted(files, key=lambda f: (f in seconds, -seconds.get(f, 0), f))
    return [item for f in order for item in files[f]]


@contextlib.contextmanager
def time_limit(nodeid, seconds):
    """Fail the test `nodeid` if the block runs `seconds` or longer."""
    def expire(signum, frame):
        pytest.fail(f"{nodeid} ran past its limit of {seconds} s",
                    pytrace=False)
    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


@contextlib.contextmanager
def backstop(item, run_dir, seconds):
    """End this process if the block runs `seconds`, the stacks of its
    threads written to a file in `run_dir`. Where a process was ended so in
    `item` before, the test's setup fails with those stacks."""
    stacks = pathlib.Path(run_dir, hashlib.sha1(item.nodeid.encode()).hexdigest())
    if stacks.exists() and stacks.stat().st_size:
        item.stash[_ended] = stacks.read_text()
    f = open(stacks, "w")
    faulthandler.dump_traceback_later(seconds, exit=True, file=f)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        f.close()
        stacks.unlink()


def pytest_configure(config):
    # xdist queues files by their number of tests unless told otherwise;
    # the collection's own order (longest_files_first) is the one wanted.
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False
    if not hasattr(config, "workerinput"):
        config.stash[_run_dir] = make_run_dir()
        os.environ[RUN_DIR_ENV] = config.stash[_run_dir]


def pytest_unconfigure(config):
    if _run_dir in config.stash:
        remove_run_dir(config.stash[_run_dir])


def pytest_collection_modifyitems(config, items):
    items[:] = longest_files_first(items, json.loads(FILE_SECONDS.read_text()))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    with contextlib.ExitStack() as limits:
        if hasattr(item.config, "workerinput"):
            limits.enter_context(
                backstop(item, os.environ[RUN_DIR_ENV], _BACKSTOP_S))
        limits.enter_context(time_limit(item.nodeid, TEST_LIMIT_S))
        return (yield)


def pytest_runtest_setup(item):
    if _ended in item.stash:
        pytest.fail(f"a worker was ended {_BACKSTOP_S} s into {item.nodeid}; "
                    f"its threads' stacks:\n{item.stash[_ended]}",
                    pytrace=False)
