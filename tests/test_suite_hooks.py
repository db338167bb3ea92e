"""The suite's own hooks (tests/suite_hooks.py and the root conftest.py): the
time limit of a case, the controller-only build of the JAX package's runtime
library, and the cases marked `slow`."""

import ast
import os
import subprocess
import types

import pytest

import suite_hooks


def run_with_hooks(pytester, monkeypatch, body, *args, **files):
    """Run `body` as test_timed.py, beside `files`, in a fresh pytest process
    with only suite_hooks loaded (no repo conftest, so no JAX), at a 2 s
    limit and 1 s more before a hang's stacks."""
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [os.path.dirname(__file__), os.environ.get("PYTHONPATH", "")]))
    pytester.makeconftest("""
        import suite_hooks

        suite_hooks.DEFAULT_LIMIT_S = 2.0
        suite_hooks.STACKS_AFTER_S = 1.0

        def pytest_configure(config):
            config.addinivalue_line("markers", "slow: over the bar")
    """)
    pytester.makepyfile(test_timed=body, **files)
    return pytester.runpytest_subprocess("-p", "suite_hooks", "-p",
                                         "no:cacheprovider", *args, timeout=60)


def test_case_past_its_limit_fails_and_the_next_case_runs(pytester,
                                                          monkeypatch):
    result = run_with_hooks(pytester, monkeypatch, """
        import time

        def test_sleeps():
            time.sleep(60)

        def test_after():
            pass
    """)
    result.assert_outcomes(passed=1, failed=1)
    result.stdout.fnmatch_lines(
        ["*test_sleeps ran past its time limit of 2 s*"])
    assert result.duration < 30


def test_case_within_its_limit_passes(pytester, monkeypatch):
    result = run_with_hooks(pytester, monkeypatch, """
        import signal
        import time
        import pytest

        def test_short():
            time.sleep(0.2)
            # The limit is armed while the case runs.
            assert 0 < signal.getitimer(signal.ITIMER_REAL)[0] <= 2

        @pytest.mark.slow
        def test_slow_gets_the_longer_limit():
            assert signal.getitimer(signal.ITIMER_REAL)[0] > 1000
    """)
    result.assert_outcomes(passed=2)


def test_native_hang_ends_its_worker_and_the_run_goes_on(pytester,
                                                         monkeypatch):
    # With SIGALRM blocked the alarm's handler never runs, as in a case
    # stuck in native code; the stack dump then ends the worker. The worker
    # has finished test_first.py by then, which xdist queues again.
    result = run_with_hooks(pytester, monkeypatch, """
        import signal
        import time

        def test_hangs():
            signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
            time.sleep(60)

        def test_after():
            pass
    """, "-p", "xdist", "-n", "1", "--dist", "loadfile",
        test_first="def test_one():\n    pass\n\n\ndef test_two():\n    pass\n")
    result.assert_outcomes(passed=3, failed=1)
    result.stdout.fnmatch_lines(["*crashed while running*test_hangs*"])
    result.stderr.fnmatch_lines(["Timeout (0:00:03)!*"])
    assert result.duration < 30


def test_runtime_builds_in_the_controller_only(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(
        suite_hooks.subprocess, "run",
        lambda cmd, **kw: calls.append(cmd) or
        subprocess.CompletedProcess(cmd, 0, "", ""))
    worker = types.SimpleNamespace(workerinput={"workerid": "gw0"})
    suite_hooks.build_runtime_once(worker, str(tmp_path))
    assert calls == []
    suite_hooks.build_runtime_once(types.SimpleNamespace(), str(tmp_path))
    assert calls == [["make", "-C", str(tmp_path), "all"]]


def _exits_2(cmd, **kw):
    return subprocess.CompletedProcess(cmd, 2, "", "runtime.cc:1: error: x")


def _hangs(cmd, **kw):
    raise subprocess.TimeoutExpired(cmd, kw["timeout"])


def _no_make(cmd, **kw):
    raise FileNotFoundError(2, "No such file or directory", "make")


@pytest.mark.parametrize("run, why", [
    (_exits_2, "make exited 2: runtime.cc:1: error: x"),
    (_hangs, "timed out after 120"),
    (_no_make, "No such file or directory"),
])
def test_failed_runtime_build_warns_and_the_run_goes_on(monkeypatch,
                                                        tmp_path, run, why):
    monkeypatch.setattr(suite_hooks.subprocess, "run", run)
    warned = []
    config = types.SimpleNamespace(
        issue_config_time_warning=lambda w, stacklevel: warned.append(w))
    suite_hooks.build_runtime_once(config, str(tmp_path))
    assert len(warned) == 1
    assert isinstance(warned[0], pytest.PytestWarning)
    assert why in str(warned[0]) and str(tmp_path) in str(warned[0])


def test_each_slow_case_exists(request):
    """A renamed case would drop out of `SLOW` unseen, back into tier-1."""
    root = request.config.rootpath
    conftest = next(p for p in request.config.pluginmanager.get_plugins()
                    if getattr(p, "__file__", None) == str(root / "conftest.py"))
    assert len(conftest.SLOW) == 4
    for nodeid in conftest.SLOW:
        path, name = nodeid.split("::")
        tree = ast.parse((root / path).read_text())
        assert name in {f.name for f in tree.body
                        if isinstance(f, ast.FunctionDef)}, nodeid
