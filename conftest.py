"""Loads tests/suite_schedule.py, the plugin that schedules a run of the test
suite across its xdist workers. It is registered here, at the repository's
root, so that it is read before the workers start."""
pytest_plugins = ("tests.suite_schedule",)
