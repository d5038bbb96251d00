"""The root ``conftest.py``'s thread rule: an xdist worker runs torch on its
share of the CPUs, and a run without xdist keeps its threads."""

import os
from pathlib import Path

import torch

ROOT_CONFTEST = Path(__file__).resolve().parent.parent / "conftest.py"


def _root_conftest(config):
    """The module pytest loaded from the root ``conftest.py``."""
    for plugin in config.pluginmanager.get_plugins():
        if Path(getattr(plugin, "__file__", "") or "").resolve() == ROOT_CONFTEST:
            return plugin
    raise AssertionError("the root conftest.py is not loaded")


def test_a_worker_gets_its_share_of_threads(request):
    root = _root_conftest(request.config)
    rule = root.worker_threads
    for cpus in (1, 4, 8, 13, 64):
        for n in (1, 2, 6, 8, 16):
            assert rule({"PYTEST_XDIST_WORKER_COUNT": str(n)}, cpus) == max(1, cpus // n)
    assert rule({}, 8) is None
    assert rule({"PYTEST_XDIST_WORKER_COUNT": "6", "OMP_NUM_THREADS": "3"}, 8) is None
    assert rule({"PYTEST_XDIST_WORKER_COUNT": "6"}, None) == 1

    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:  # an xdist worker: the rule's threads, or its caller's own
        if root.WORKER_THREADS is not None:
            assert root.WORKER_THREADS == max(1, os.cpu_count() // int(workers))
        assert torch.get_num_threads() == int(os.environ["OMP_NUM_THREADS"])
    else:
        assert root.WORKER_THREADS is None
