"""Write tests/file_seconds.json, the seconds each test file took in a whole
run of the suite, from that run's junit XML.

    python tools/file_seconds.py run.xml [-o tests/file_seconds.json]

tests/suite_schedule.py hands the files to the test workers longest first by this
table. Each testcase's time is summed into the file that holds it: the junit
classname (``tests.test_ba.TestBA``) names the longest dotted prefix that is
a ``.py`` file under the repository's root. The table maps each file's path
under ``tests/`` to its whole seconds.
"""
import argparse
import collections
import json
import pathlib
import xml.etree.ElementTree as ET

ROOT = pathlib.Path(__file__).resolve().parent.parent
TESTS = ROOT / "tests"


def file_of(classname):
    """The path under tests/ of the file that holds a junit classname."""
    parts = classname.split(".")
    for n in range(len(parts), 0, -1):
        path = ROOT.joinpath(*parts[:n]).with_suffix(".py")
        if path.is_file():
            return path.relative_to(TESTS).as_posix()
    raise ValueError(f"no test file holds junit classname {classname!r}")


def file_seconds(xml_path):
    """{file under tests/: whole seconds} summed over a junit XML's cases.
    A case without a classname (a file that failed to collect) is left out."""
    seconds = collections.Counter()
    for case in ET.parse(xml_path).getroot().iter("testcase"):
        if case.get("classname"):
            seconds[file_of(case.get("classname"))] += float(case.get("time", 0))
    return {f: round(s) for f, s in sorted(seconds.items())}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("junit_xml")
    ap.add_argument("-o", "--out", default=str(TESTS / "file_seconds.json"))
    args = ap.parse_args()
    table = file_seconds(args.junit_xml)
    with open(args.out, "w") as f:
        json.dump(table, f, indent=1)
        f.write("\n")
    print(f"{len(table)} files, {sum(table.values())} s -> {args.out}")


if __name__ == "__main__":
    main()
