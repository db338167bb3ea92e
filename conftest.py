"""Suite-wide pytest settings, loaded before tests/conftest.py.

- Registers `tests/suite_hooks.py` (every case's time limit) and `pytester`
  (which the hooks' own tests use).
- Builds the JAX package's runtime library once, in the controller, before
  xdist starts its workers: tests/test_runtime.py asks `is_available()` at
  import, in every worker.
- Marks `slow` the cases in `SLOW`; tier-1 runs `-m 'not slow'`, and
  `-m slow` runs them.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "tests"))

pytest_plugins = ("pytester", "suite_hooks")

# Over tier-1's 120 s bar, and testing only the JAX package. Each case
# compiles XLA programs of its own, 365-411 s (the `pair`-mesh GICP solves)
# and 345-405 s (the dryruns) with its file alone and a cold cache, 415-570 s
# under tier-1's six workers. The second case of each pair compiles as long
# as the first, in the same process: the two `pair`-mesh cases do not share
# one SPMD executable, and the broken-solver dryrun does not reuse the
# healthy one's programs, whatever their comments say. The port's batched,
# rig-pair, sharded and multi-process paths stay in tier-1
# (tests/test_torch_solvers.py, test_torch_sharded_rig.py,
# test_torch_multihost.py).
SLOW = frozenset({
    "tests/test_gicp_distributed.py::test_batched_pair_solves_bitwise_match_sequential",
    "tests/test_gicp_distributed.py::test_register_rig_pairs_adjacent",
    "tests/test_graft_interfaces.py::test_dryrun_multichip_small",
    "tests/test_graft_interfaces.py::test_dryrun_multichip_fails_on_broken_solver",
})


def pytest_configure(config):
    import suite_hooks

    suite_hooks.build_runtime_once(config, os.path.join(ROOT, "runtime"))


@pytest.hookimpl(tryfirst=True)  # before `-m` deselects
def pytest_collection_modifyitems(items):
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)
