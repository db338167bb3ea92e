"""The output check's control: the plain reference in the program's place,
computed in the precision below the configuration's (bfloat16 geometry for
float32), judged by the same comparison as a run.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

For each seed it renders the cell's frame pool, hands every camera the
frames of two pool periods in order, draws the run's number of sampled
frames from the seed, and judges the bfloat16 reference's outputs against
the float32 one's by the cell's comparison (the driver's ``compare``, or
the image mismatch share): it prints one control reading per number
compared, the upper reading of that number's limit. The benchmark's own
runs never run it.
"""

import argparse
import json
import pathlib
import random
import sys
import types


def control(cell_name: str, seed: int, device, config_hook=None, repo=None,
            bench=None) -> dict:
    """``{name: the control's reading}`` for each number the cell's check
    compares, on one seed; ``repo`` and ``bench`` locate a checkout."""
    import torch  # noqa: PLC0415

    from benchmark import harness  # noqa: PLC0415
    from benchmark.scene.render import render_pool  # noqa: PLC0415
    from benchmark.traffic.generator import load_mix  # noqa: PLC0415

    repo = repo or harness.REPO_DIR
    bench = bench or harness.BENCH_DIR
    manifest = harness.load_manifest(repo)
    cell = next(w for w in manifest["workloads"] if w["name"] == cell_name)
    config = harness.load_config(manifest, cell["config"], repo)
    if config_hook is not None:
        config = config_hook(config)
    mix = load_mix(cell["traffic"], bench / "traffic")
    driver = harness.driver_module(config["driver"], bench)
    pool = render_pool(config, int(mix["pool_frames"]), seed, device)
    frames = 2 * pool["depth"].shape[1]
    handed = list(range(-int(mix["warmup_frames"]), frames))
    rec = types.SimpleNamespace(sources=[types.SimpleNamespace(handed=handed)]
                                * pool["depth"].shape[0])
    ks = sorted(random.Random(seed).sample(range(frames), harness.SAMPLE_IMAGES))
    exact = driver.reference_images(config, pool, rec, ks, device)
    low = driver.reference_images(config, pool, rec, ks, device, dtype=torch.bfloat16)
    checks, _ = harness.check_outputs(driver, low, exact, config, pool)
    return {name: c["value"] for name, c in checks.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import torch  # noqa: PLC0415

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        readings = control(args.workload, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **{f"control_{name}": v for name, v in readings.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
