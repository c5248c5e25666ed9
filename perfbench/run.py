"""The benchmark of the PyTorch port: one cell, one run.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Set-up (imports, inputs and weights made
from the seed, the cell's captures and warm-ups), then the measured
window, then the comparison with the plain reference that decides
``correct``. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit, which also end standard error.

A run needs a CUDA device: without one, or with fewer than the cell
asks for, it exits 2 and prints no result. After the window it exits 3
and prints no result if JAX, jaxlib, flax or the JAX package is loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "neural_human_video_rendering_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def result_line(bench: dict, args, res, device: dict, checks: dict) -> dict:
    from .harness.bench import metrics_of, reader
    section = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in metrics_of(bench, args.workload, section):
        if section == "end_to_end":
            value = res.e2e.get(m["name"])
        else:
            value = reader(m["name"])(res.readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "attempted": res.attempted, "failed": res.failed,
            "metrics": metrics, "device": device}
    trace = res.readings.get("trace")
    if args.trace and trace is not None:
        line["breakdown"] = {"device_ops": trace["device_ops"],
                             "idle_gaps": trace["idle_gaps"]}
    line["checks"] = checks
    return line


def execute(args, device, chips: int, side: str = "program") -> dict:
    """Everything of a run after the look for a card: set-up, window,
    reference, the result line. Raises SystemExit(3) where a forbidden
    module was loaded. ``side`` lets the harness's tests put the control
    or a planted fault in the program's place."""
    import torch

    from .harness import bench as hb
    from .harness.compare import check

    spec = hb.benchmark()
    cell = hb.cell(spec, args.workload)
    traffic = hb.traffic(cell["traffic"])
    run = hb.Run(workload=args.workload, seed=args.seed,
                 seconds=args.seconds, trace=bool(args.trace),
                 flags=hb.configuration(spec, cell["config"])["flags"],
                 traffic=traffic, limits=hb.limits(args.workload),
                 device=device, t0=T0, side=side)
    res = hb.kind(traffic["kind"]).run(run)
    found = forbidden_modules()
    if found:
        hb.log(f"perfbench: forbidden modules loaded: {found}")
        raise SystemExit(3)
    info = {"platform": "gpu", "count": chips,
            "memory_peak_bytes": int(res.memory_peak_bytes)}
    if device.type == "cuda":
        info["kind"] = torch.cuda.get_device_name(device)
    trace = res.readings.get("trace")
    if args.trace and trace is not None:
        info.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    checks = check(res.numbers, run.limits)
    line = result_line(spec, args, res, info, checks)
    for name in sorted(set(res.numbers) - set(checks)):
        hb.log(f"read {name} {res.numbers[name]!r} (not compared)")
    for name, c in checks.items():
        hb.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return line


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")

    import torch

    from .harness import bench as hb

    chips = hb.cell(hb.benchmark(), args.workload)["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        hb.log(f"perfbench: the cell needs {chips} CUDA device(s); "
               f"found {found}")
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    line = execute(args, dev, chips)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
