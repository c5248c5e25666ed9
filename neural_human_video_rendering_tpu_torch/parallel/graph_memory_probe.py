#!/usr/bin/env python3
"""The memory of a graphed flagship rank, and phase 12(a)'s check with the
ranks on the graphed route as the card's free memory shrinks:

    python3 neural_human_video_rendering_tpu_torch/parallel/graph_memory_probe.py \\
        [--free_gb none,45,30,22] [--unrepaired]

chip_smoke's phase 12(a) setting (its TRAIN and PAR_EXACT flags: the
flagship widths in float32, SGD(1), one global batch of 2). First one
rank's step alone in this process (``selfcheck.rank_step`` at one rank's
shapes, one sample), graphed, with its capture's allocator record
(``graphs.Program.memory``): the bytes reserved at the capture's start,
after the state's saved copy, after the warm-up, after the release of
the warm-up's blocks and after the capture, the bytes the capture's pool
holds, the peak reserved and the caught out-of-memory errors. With
--unrepaired it measures that rank first as the capture ran before the
repair (the saved copy on the card, the warm-up's blocks kept), in the
same process. Then the two ranks as eager threads of this process (the
reference), then two gloo ranks sharing cuda:0 on make_train_step's
graphed route, once for each --free_gb entry: ``none`` the card as it
is, a number with this process holding all but that many GB of it. For
each it prints the ranks' err/tol against the threads in the parity
tests' form and each rank's caught out-of-memory count, peak reservation
and capture record (``torch.cuda.memory_stats``): cuDNN's plan search
takes another algorithm when the allocator refuses a plan's workspace.
Exits non-zero without a CUDA card.
"""

import argparse
import contextlib
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FREE_GB = "none,45,30,22"          # none: the card as it is


def _gb(record):
    """An allocator record with its byte counts in GB."""
    if record is None:
        return None
    return {k: (v / 1e9 if isinstance(v, int) and k != "num_ooms" else v)
            for k, v in record.items()}


def rank_probe(opt, batch, atlas, bg, out_dir, n, dp=None):
    """selfcheck.rank_step on the graphed route, then this rank's
    allocator record."""
    import torch
    from neural_human_video_rendering_tpu_torch.parallel import selfcheck as sc
    sc.rank_step(opt, batch, atlas, bg, out_dir, n, dp=dp)
    st = torch.cuda.memory_stats()
    print(f"[graph_memory_probe] rank {dp.rank}: caught out-of-memory "
          f"{st.get('num_ooms')}, alloc retries "
          f"{st.get('num_alloc_retries')}, peak reserved "
          f"{torch.cuda.max_memory_reserved() / 1e9:.2f} GB", flush=True)


@contextlib.contextmanager
def unrepaired():
    """graphs.Program's capture as it ran before the repair: the state's
    saved copy on the card and the warm-up's blocks kept."""
    from neural_human_video_rendering_tpu_torch.train import graphs
    saved = graphs._saved_copy, graphs._release
    graphs._saved_copy = lambda t: t.detach().clone()
    graphs._release = lambda device, state: None
    try:
        yield
    finally:
        graphs._saved_copy, graphs._release = saved


def one_rank(torch, sc, opt, batch, atlas, bg, out_dir, dev):
    """One rank's step alone (one sample, graphed), from a released cache
    and a reset peak: its capture's record and the process's peak."""
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ooms = torch.cuda.memory_stats(dev).get("num_ooms", 0)
    from neural_human_video_rendering_tpu_torch.parallel.mesh import \
        DataParallel
    rows = {k: v[:1] for k, v in batch.items()}
    sc.rank_step(opt, rows, atlas, bg, out_dir, 1, dp=DataParallel.solo(dev))
    rec = torch.load(os.path.join(out_dir, "rank0.pt"))["allocator"]
    out = {"capture": _gb(rec["capture"]),
           "peak_reserved_gb": torch.cuda.max_memory_reserved(dev) / 1e9,
           "num_ooms": torch.cuda.memory_stats(dev).get("num_ooms", 0)
           - ooms}
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--free_gb", default=FREE_GB,
                    help="comma-separated rows: none or GB left free")
    ap.add_argument("--unrepaired", action="store_true",
                    help="also measure one rank as captured before the "
                         "repair")
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("graph_memory_probe: no CUDA card", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from neural_human_video_rendering_tpu_torch.config import TrainOptions
    from neural_human_video_rendering_tpu_torch.data import dataset as dsm
    from neural_human_video_rendering_tpu_torch.ops import build
    from neural_human_video_rendering_tpu_torch.parallel import selfcheck as sc
    from neural_human_video_rendering_tpu_torch.runtime import launch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    dev = torch.device("cuda", 0)
    work = os.path.join(ROOT, "build", "graph_memory_probe")
    o2 = TrainOptions().parse(cs.TRAIN + cs.PAR_EXACT + [cs.PAR_TWO],
                              save=False)
    syn = dsm.SyntheticDataset(o2, length=12, seed=o2.seed)
    batch = dsm.collate([syn[i] for i in (1, 11)])
    atlas = sc.linear_atlas(o2.n_parts, o2.tex_tile)
    bg = syn.background()
    result = {"card": torch.cuda.get_device_name(0)}
    o1 = TrainOptions().parse(cs.TRAIN + cs.PAR_EXACT + [cs.PAR_ONE],
                              save=False)
    for name in (("unrepaired", "repaired") if a.unrepaired
                 else ("repaired",)):
        with unrepaired() if name == "unrepaired" else \
                contextlib.nullcontext():
            row = one_rank(torch, sc, o1, batch, atlas, bg,
                           os.path.join(work, f"one_{name}"), dev)
        print(f"[graph_memory_probe] one rank alone, {name}: "
              f"{json.dumps(row)}", flush=True)
        result[f"one_rank_{name}"] = row
    threads = os.path.join(work, "threads")
    sc.thread_ranks(o2, batch, atlas, bg, threads, 1, 2, dev)
    torch.cuda.empty_cache()
    out = []
    for entry in a.free_gb.split(","):
        free_gb = None if entry == "none" else float(entry)
        filler = None
        if free_gb is not None:
            free = torch.cuda.mem_get_info(dev)[0] / 1e9
            filler = torch.empty(int((free - free_gb) * 1e9),
                                 dtype=torch.uint8, device=dev)
        ranks = os.path.join(work, f"ranks_free_{entry}")
        t0 = time.perf_counter()
        row = {"free_gb": free_gb}
        try:
            launch(rank_probe, o2, batch, atlas, bg, ranks, 1, where=work,
                   batch=o2.batchSize)
            got = sc.compare(threads, ranks, cs.PAR_SCALE_TOL,
                             cs.PAR_TENSOR_TOL)
            row.update({"err_over_tol": {m: r["ratio"] for m, r in
                                         got["delta_ratio"].items()},
                        "loss_max_rel": got["loss_max_rel"],
                        "ranks": [dict(_gb({k: v for k, v in r.items()
                                            if k != "capture"}),
                                       capture=_gb(r["capture"]))
                                  for r in got["allocator"]]})
        except Exception as e:          # noqa: BLE001 - a rank ran out
            row["error"] = f"{type(e).__name__}: {str(e)[:200]}"
        row["s"] = time.perf_counter() - t0
        print(f"[graph_memory_probe] {json.dumps(row)}", flush=True)
        out.append(row)
        del filler
        torch.cuda.empty_cache()
    result["two_ranks"] = out
    print(json.dumps({"graph_memory_probe": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
