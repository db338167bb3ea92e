"""Run one cell of BENCHMARK.json once on this machine's CUDA device(s).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
``checks``: each number the output check compared, with its limit. The
toolchain, the card, the heap settings and the generator's lateness go to
standard error before it, and the checks once more as its last lines. Exits non-zero,
with no result, without enough CUDA devices, or when JAX or the JAX
package was loaded.

Everything is found by the names in ``BENCHMARK.json``. A new configuration
comes as new files and new entries alone: ``configs/<config>.json`` (its
sizes, its ``rig`` of a ``pair`` or an ``arc`` of N cameras, the scene, the
``driver`` it uses and under ``check`` the limit of each number compared),
``drivers/<driver>.py`` where no driver fits (``host_frameset()``,
``build(...)`` of the node on the benchmark's cameras,
``reference_images(...)`` of the plain reference's outputs and, where the
outputs are not images, ``compare(got, ref, config, pool) -> {name:
float}``), its plain reference under ``reference/``, ``traffic/<mix>.json``
where no mix fits, ``metrics/<metric>.py`` for each new metric, and the
``configs``, ``workloads`` and metric entries of ``BENCHMARK.json``.
``harness.py``'s docstring gives the driver's calls in full;
``control.py`` reads the control of a cell's check.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import ctypes  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: glibc's mallopt parameters, by the names a configuration's host.malloc uses.
_MALLOPT = {"trim_threshold": -1, "mmap_threshold": -3, "arena_max": -8}


def set_heap(workload: str) -> dict:
    """Set glibc's heap as the cell's configuration states it under
    ``host.malloc``, before anything large is allocated (a deployment sets
    the same through MALLOC_ARENA_MAX, MALLOC_MMAP_THRESHOLD_ and
    MALLOC_TRIM_THRESHOLD_). A configuration without the key runs glibc's
    defaults. Returns what was set, and whether glibc took it."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if cell is None:
        return {}
    entry = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    malloc = json.loads((ROOT / entry["file"]).read_text()).get("host", {}).get("malloc", {})
    if not malloc:
        return {}
    libc = ctypes.CDLL("libc.so.6")
    ok = all(libc.mallopt(_MALLOPT[k], int(v)) == 1 for k, v in malloc.items())
    return dict(malloc, applied=ok)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    heap = set_heap(args.workload)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    return harness.main(args, T_START, heap=heap)


if __name__ == "__main__":
    sys.exit(main())
