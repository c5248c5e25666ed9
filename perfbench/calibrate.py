"""Readings for the limits of ``correct``: the program, the control and
planted faults on several seeds, in one process on the card.

    python3 -m perfbench.calibrate --workload <cell> --seeds 1,2,3 \\
        --sides program,control,fault:half_batch [--seconds 2] \\
        [--out calibrate.jsonl]
    python3 -m perfbench.calibrate --workload <serve cell> --seeds 1 \\
        --rates 20,24,28 --seconds 10

Each side runs the cell as ``perfbench.run`` does, with a short window
(``--seconds``), and prints one JSON line a (side, seed): the numbers
compared and the readings behind them. ``--rates`` instead loads a
serving cell's program once and sends a window at each rate, printing
the latencies and whether the backlog grew. Not run by the benchmark.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sides", default="program,control")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="")
    ap.add_argument("--rates", default="")
    a = ap.parse_args(argv)
    import torch
    from .harness import bench as hb
    if not torch.cuda.is_available():
        hb.log("calibrate: no CUDA device")
        return 2
    spec = hb.benchmark()
    cell = hb.cell(spec, a.workload)
    traffic = hb.traffic(cell["traffic"])
    flags = hb.configuration(spec, cell["config"])["flags"]
    dev = torch.device("cuda", 0)
    out = open(a.out, "a") if a.out else None
    if a.rates:
        return sweep(a, flags, traffic, dev)
    for seed in [int(s) for s in a.seeds.split(",")]:
        for side in a.sides.split(","):
            t0 = time.perf_counter()
            run = hb.Run(workload=a.workload, seed=seed, seconds=a.seconds,
                         trace=False, flags=flags, traffic=traffic,
                         limits={}, device=dev, t0=t0, side=side)
            res = hb.kind(traffic["kind"]).run(run)
            rec = {"workload": a.workload, "seed": seed, "side": side,
                   "numbers": res.numbers, "e2e": res.e2e,
                   "detail": res.readings.get("detail"),
                   "seconds": time.perf_counter() - t0,
                   "peak": res.memory_peak_bytes}
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            del res
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
    if out:
        out.close()
    return 0


def sweep(a, flags, traffic, dev) -> int:
    """One serving program, a window at each rate."""
    import tempfile
    from pathlib import Path

    from .harness import bench as hb
    from .harness.window import percentile
    from .kinds import serve
    from .reference.config import reference_config
    cfg = reference_config(flags)
    run = hb.Run(workload=a.workload, seed=int(a.seeds.split(",")[0]),
                 seconds=a.seconds, trace=False, flags=flags,
                 traffic=traffic, limits={}, device=dev,
                 t0=time.perf_counter())
    with tempfile.TemporaryDirectory() as where:
        system = serve.prepare(run, cfg, Path(where))
        for rate in [float(r) for r in a.rates.split(",")]:
            due, joints = serve.requests(run, cfg, rate, a.seconds)
            lat, outs, late, _, due = serve.window(system, due, joints,
                                                   traffic["clients"])
            first, last = serve.backlog(due, outs)
            fwd = [o.forward_s for o in outs if o is not None]
            print(json.dumps({
                "rate": rate, "requests": len(due),
                "p50_ms": 1e3 * percentile(lat, 50),
                "p95_ms": 1e3 * percentile(lat, 95),
                "forward_ms_p50": 1e3 * percentile(fwd, 50),
                "wait_first_quarter_s": first, "wait_last_quarter_s": last,
                "late_max_ms": 1e3 * max(late)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
