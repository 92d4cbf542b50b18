"""The suite's own scheduling in tests/suite_schedule.py: the order files go
to the workers in, the limit on each test and the run's directory; and
tools/file_seconds.py, which writes the table the order is read from. CPU
only, seconds."""
import importlib.util
import os
import pathlib
import random
import signal
import tempfile
import time
import types

import pytest

from tests import suite_schedule

REPO = suite_schedule.TESTS_DIR.parent
_spec = importlib.util.spec_from_file_location(
    "file_seconds", REPO / "tools" / "file_seconds.py")
file_seconds = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(file_seconds)


def _items(spec):
    """Fake collected items: (file, number of tests) pairs in order."""
    return [types.SimpleNamespace(path=suite_schedule.TESTS_DIR / f,
                                  nodeid=f"{f}::test_{i}")
            for f, n in spec for i in range(n)]


def test_longest_files_first():
    seconds = {"test_a.py": 10, "test_b.py": 30, "test_c.py": 10}
    items = _items([("test_a.py", 2), ("test_new1.py", 1), ("test_c.py", 3),
                    ("test_b.py", 1), ("test_new0.py", 2)])
    got = [it.nodeid for it in suite_schedule.longest_files_first(items, seconds)]
    assert got == [
        "test_new0.py::test_0", "test_new0.py::test_1",   # unknown, by path
        "test_new1.py::test_0",
        "test_b.py::test_0",                               # 30 s
        "test_a.py::test_0", "test_a.py::test_1",          # 10 s, by path
        "test_c.py::test_0", "test_c.py::test_1", "test_c.py::test_2",
    ]
    again = suite_schedule.longest_files_first(items, seconds)
    assert [it.nodeid for it in again] == got
    # The order does not hang on the order the files were collected in.
    by_file = {}
    for it in items:
        by_file.setdefault(it.path, []).append(it)
    files = list(by_file.values())
    random.Random(0).shuffle(files)
    shuffled = [it for f in files for it in f]
    assert [it.nodeid for it in
            suite_schedule.longest_files_first(shuffled, seconds)] == got


def test_time_limit_fails_a_test_that_runs_past_it():
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception,
                       match=r"tests/test_x\.py::test_y ran past its limit "
                             r"of 1 s"):
        with suite_schedule.time_limit("tests/test_x.py::test_y", 1):
            time.sleep(3)
    assert time.monotonic() - t0 < 2.5
    assert signal.alarm(0) == 0


def test_time_limit_is_disarmed_after_a_test_in_time():
    handler = signal.getsignal(signal.SIGALRM)
    with suite_schedule.time_limit("tests/test_x.py::test_y", 5):
        pass
    assert signal.alarm(0) == 0
    assert signal.getsignal(signal.SIGALRM) is handler


def test_run_dir_is_fresh_and_in_the_temp_dir():
    tmp = pathlib.Path(tempfile.gettempdir()).resolve()
    first = pathlib.Path(suite_schedule.make_run_dir()).resolve()
    second = pathlib.Path(suite_schedule.make_run_dir()).resolve()
    try:
        assert first.parent == tmp and second.parent == tmp
        assert first != second
        # Inside the repository only where the temp dir itself is.
        assert not first.is_relative_to(REPO) or tmp.is_relative_to(REPO)
    finally:
        suite_schedule.remove_run_dir(first)
        suite_schedule.remove_run_dir(second)
    assert not first.exists() and not second.exists()


def test_run_dir_is_handed_to_the_workers():
    assert pathlib.Path(os.environ[suite_schedule.RUN_DIR_ENV]).is_dir()


def test_file_seconds_sums_a_junit_xml_per_file(tmp_path):
    xml = tmp_path / "run.xml"
    xml.write_text(
        '<testsuites><testsuite name="pytest">'
        '<testcase classname="tests.test_ba.TestBA" name="a" time="1.4"/>'
        '<testcase classname="tests.test_ba.TestBA" name="b" time="0.4"/>'
        '<testcase classname="tests.test_server" name="c" time="2.6"/>'
        '<testcase classname="" name="tests.test_gone" time="0.1"/>'
        '</testsuite></testsuites>')
    assert file_seconds.file_seconds(xml) == {
        "test_ba.py": 2, "test_server.py": 3}
    with pytest.raises(ValueError, match="tests.test_nowhere"):
        file_seconds.file_of("tests.test_nowhere")
