"""How pytest-xdist shares the tests out among its workers.

`--dist loadfile` (pytest.ini) runs each test file whole on one worker.
The SEAL sweep, `tests/test_sweep.py`, is six whole verified auctions:
on one worker it alone takes most of the run's time limit, so the run
ends when that worker does.  Here each of its tests is a unit of its
own, which xdist hands to whichever worker is free; every other file
still runs whole on one worker.  No test file changes for this.
"""

import pytest

# files whose every test is its own unit of work under --dist loadfile
SPREAD = ("tests/test_sweep.py",)


def scope(nodeid):
    """The unit of work `nodeid` belongs to: its file, or itself if its
    file is in SPREAD."""
    path = nodeid.split("::", 1)[0]
    return nodeid if path in SPREAD else path


@pytest.hookimpl(tryfirst=True, optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class SpreadFileScheduling(LoadFileScheduling):
        def _split_scope(self, nodeid):
            return scope(nodeid)

    return SpreadFileScheduling(config, log)
