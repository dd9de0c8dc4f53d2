"""Repository-wide pytest hooks: how ``--dist loadfile`` schedules the tests.

``pytest -n N --dist loadfile`` hands each test file to one worker, so a
file's tests run one after the other, and queues the files by test count,
most first. The tests of ``LONG_TEST_FILES`` take minutes each on the CPU.
Those of the JAX reference's ``tests/test_parallel.py`` compile hundreds of
small programs for the 8-device virtual mesh, none slow enough for the
persistent cache, and take about as long on every call; as one file they
started minutes into the run and then ran for about 1,000 s on a single
worker while the others idled. ``tests/test_example_colmap_e2e.py`` is one
test of several minutes that the count order started last. Each test of
these files is scheduled as a unit of its own at the front of the queue, so
that they start first, on different workers. Every other file stays one
unit, in xdist's order.
"""

import pytest

#: Test files whose tests take minutes each on the CPU.
LONG_TEST_FILES = frozenset({
    "tests/test_parallel.py",
    "tests/test_example_colmap_e2e.py",
})


def scope_of(nodeid):
    """The unit of work ``--dist loadfile`` schedules ``nodeid`` in: the
    test itself for ``LONG_TEST_FILES``, else its file."""
    path = nodeid.split("::", 1)[0]
    return nodeid if path in LONG_TEST_FILES else path


def front_first(queue):
    """Move the one-test units (``scope_of`` gave a node id) to the front of
    xdist's queue, an ordered mapping of unit to tests, in their order."""
    for scope in reversed([s for s in queue if "::" in s]):
        queue.move_to_end(scope, last=False)


@pytest.hookimpl(optionalhook=True, tryfirst=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class Scheduling(LoadFileScheduling):
        def _split_scope(self, nodeid):
            return scope_of(nodeid)

        def _assign_work_unit(self, node):
            front_first(self.workqueue)
            super()._assign_work_unit(node)

    return Scheduling(config, log)
