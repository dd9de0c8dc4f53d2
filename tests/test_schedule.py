"""The repository's ``--dist loadfile`` schedule (``conftest.py`` at the root)."""

import collections
import importlib.util
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

_spec = importlib.util.spec_from_file_location("root_conftest", ROOT / "conftest.py")
root_conftest = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(root_conftest)


@pytest.mark.parametrize("nodeid, unit", [
    ("tests/test_parallel.py::test_tile_sharded_grads_match_single",
     "tests/test_parallel.py::test_tile_sharded_grads_match_single"),
    ("tests/test_parallel.py::test_mesh_helper",
     "tests/test_parallel.py::test_mesh_helper"),
    ("tests/test_example_colmap_e2e.py::test_train_from_colmap_example_end_to_end",
     "tests/test_example_colmap_e2e.py::test_train_from_colmap_example_end_to_end"),
    ("tests/test_train.py::test_overfit_short", "tests/test_train.py"),
    ("tests/test_torch_fixture.py::test_fixture_is_current[medium]",
     "tests/test_torch_fixture.py"),
])
def test_scope_of(nodeid, unit):
    assert root_conftest.scope_of(nodeid) == unit


def test_long_test_files_exist():
    assert all((ROOT / path).is_file() for path in root_conftest.LONG_TEST_FILES)


def test_front_first_keeps_order():
    queue = collections.OrderedDict(
        (scope, {}) for scope in ["a.py", "p.py::t1", "b.py", "p.py::t2", "c.py"])
    root_conftest.front_first(queue)
    assert list(queue) == ["p.py::t1", "p.py::t2", "a.py", "b.py", "c.py"]


_LOGGED_TEST = """
def test_{i}():
    with open({log!r}, "a") as f:
        f.write("{name} %s %r\\n" % (os.environ["PYTEST_XDIST_WORKER"], time.time()))
    time.sleep(0.5)
"""


def test_loadfile_runs_long_tests_first_on_different_workers(tmp_path):
    """A real ``-n 3 --dist loadfile`` run: the three tests of
    ``tests/test_parallel.py`` start at once on three workers, before the
    six-test file that xdist alone would queue first."""
    log = str(tmp_path / "log.txt")
    (tmp_path / "pytest.ini").write_text("[pytest]\n")
    shutil.copy(ROOT / "conftest.py", tmp_path / "conftest.py")
    (tmp_path / "tests").mkdir()
    for name, n in (("test_parallel", 3), ("test_big", 6)):
        body = "import os\nimport time\n" + "".join(
            _LOGGED_TEST.format(i=i, log=log, name=name) for i in range(n))
        (tmp_path / "tests" / f"{name}.py").write_text(body)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-q", "-p", "no:cacheprovider",
         "-p", "xdist", "-n", "3", "--dist", "loadfile", "-p", "no:randomly"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    rows = [line.split() for line in open(log)]
    assert len(rows) == 9
    parallel = [(w, float(t)) for name, w, t in rows if name == "test_parallel"]
    big = [float(t) for name, _, t in rows if name == "test_big"]
    assert len({w for w, _ in parallel}) == 3
    assert max(t for _, t in parallel) < min(big)
