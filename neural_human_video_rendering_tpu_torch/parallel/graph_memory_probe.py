#!/usr/bin/env python3
"""The memory of a graphed flagship rank, and phase 12(a)'s check with the
ranks on the graphed route as the card's free memory shrinks:

    python3 neural_human_video_rendering_tpu_torch/parallel/graph_memory_probe.py \\
        [--free_gb none,45,30,22] [--unrepaired] [--routes]

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
takes another algorithm when the allocator refuses a plan's workspace,
and since the repair of that (``graphs.CaughtOutOfMemory``) a rank that
caught such an error is refused: the row then prints each rank's
refusal, its first line naming the program and the ops. With --routes
each --free_gb entry gives three rows instead: (i) the graphed step's
first capture and (ii) a second capture after
``torch.cuda.empty_cache()`` in the same processes, (iii) the eager step
in fresh ones, each with its caught count, refusal and, where rank 0's
step finished, err/tol against the threads (``route_rank``).
``blocked_capture`` (chip_smoke's phase 17, the card tests) makes the
card tight on purpose under a conv Program. Exits non-zero without a
CUDA card.
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
    allocator record; a refusal (graphs.CaughtOutOfMemory) is written to
    {out_dir}/refused{rank}.txt and raised again (the rank ends, and the
    launch ends the other)."""
    import torch
    from neural_human_video_rendering_tpu_torch.parallel import selfcheck as sc
    from neural_human_video_rendering_tpu_torch.train import graphs
    try:
        sc.rank_step(opt, batch, atlas, bg, out_dir, n, dp=dp)
    except graphs.CaughtOutOfMemory as e:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"refused{dp.rank}.txt"), "w") as f:
            f.write(str(e))
        print(f"[graph_memory_probe] rank {dp.rank}: "
              f"{str(e).splitlines()[0]}", flush=True)
        raise
    st = torch.cuda.memory_stats()
    print(f"[graph_memory_probe] rank {dp.rank}: caught out-of-memory "
          f"{st.get('num_ooms')}, alloc retries "
          f"{st.get('num_alloc_retries')}, peak reserved "
          f"{torch.cuda.max_memory_reserved() / 1e9:.2f} GB", flush=True)


ROUTES = ("graphed", "recaptured")     # (i), (ii): one process; (iii) apart


def route_rank(opt, batch, atlas, bg, out_dir, routes, dp=None):
    """Rows (i)-(iii): selfcheck's SGD(1) step from --seed's state, once
    for each of ``routes`` in this process: ``graphed`` make_train_step's
    graphed route (its first capture), ``recaptured`` the same after
    torch.cuda.empty_cache() and a second capture (a new state and step:
    the first ones, their pool and their cached blocks released first),
    ``eager`` the eager route (a call with a mark). Each inside
    graphs.refuse_caught_ooms, so the caught out-of-memory errors and the
    ops' lines come out as a refusal's message; where the step still
    finished, its changes are written beside it ({out_dir}/{route}/rank{r}.pt,
    compare()'s form). A step refused before it finished ends the rank (the
    ranks' collectives would part)."""
    import torch
    from neural_human_video_rendering_tpu_torch.parallel import selfcheck as sc
    from neural_human_video_rendering_tpu_torch.train import graphs
    from neural_human_video_rendering_tpu_torch.train.steps import \
        make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    rows = dp.shard_batch(batch)
    for route in routes:
        torch.cuda.synchronize(dp.device)
        torch.cuda.empty_cache()
        st = sc._state(opt, atlas, bg, dp)
        before = {"G": sc._cpu(st.renderer.state_dict()),
                  "D": sc._cpu(st.disc.state_dict()),
                  "EMA": sc._cpu(st.g_ema)}
        step = make_train_step(
            opt, st.renderer, st.disc, st.vgg,
            torch.optim.SGD(st.renderer.parameters(), lr=1.0),
            torch.optim.SGD(st.disc.parameters(), lr=1.0), dp)
        kw = {"mark": lambda name: None} if route == "eager" else {}
        ooms = torch.cuda.memory_stats(dp.device).get("num_ooms", 0)
        refused, losses = None, None
        try:
            with graphs.refuse_caught_ooms("probe", dp.device,
                                           f"the {route} step"):
                losses = {k: float(v) for k, v in step(st, rows, **kw).items()}
        except graphs.CaughtOutOfMemory as e:
            refused = str(e)
        after = {"G": sc._cpu(st.renderer.state_dict()),
                 "D": sc._cpu(st.disc.state_dict()), "EMA": sc._cpu(st.g_ema)}
        out = {"rank": dp.rank, "world": dp.world, "route": route,
               "refused": refused, "finished": losses is not None,
               "losses": losses, "checksums": None, "phase_ms": {},
               "caught": torch.cuda.memory_stats(dp.device).get(
                   "num_ooms", 0) - ooms,
               "allocator": {"max_reserved_bytes":
                             torch.cuda.max_memory_reserved(dp.device)},
               "deltas": ({m: {k: after[m][k] - before[m][k]
                               for k in before[m]} for m in before}
                          if dp.is_lead and losses is not None else None)}
        os.makedirs(os.path.join(out_dir, route), exist_ok=True)
        torch.save(out, os.path.join(out_dir, route, f"rank{dp.rank}.pt"))
        print(f"[graph_memory_probe] rank {dp.rank} {route}: caught "
              f"{out['caught']}, "
              + (refused.splitlines()[0] if refused else "no refusal"),
              flush=True)
        if losses is None:
            raise graphs.CaughtOutOfMemory(refused)
        del step, st
        torch.cuda.synchronize(dp.device)
        torch.cuda.empty_cache()


def route_rows(torch, sc, cs, launch, o2, batch, atlas, bg, threads, work,
               entry):
    """Rows (i) graphed, (ii) recaptured (both in one launch of the two
    ranks) and (iii) eager (a launch of its own) at this free memory: each
    rank's caught count and refusal, and, where rank 0's step finished, its
    err/tol against the threads."""
    from neural_human_video_rendering_tpu_torch.parallel.selfcheck import \
        delta_ratio
    ref = torch.load(os.path.join(threads, "rank0.pt"))["deltas"]
    rows = []
    for routes in (ROUTES, ("eager",)):
        base = os.path.join(work, f"routes_free_{entry}_{routes[0]}")
        t0 = time.perf_counter()
        error = None
        try:
            launch(route_rank, o2, batch, atlas, bg, base, routes,
                   where=work, batch=o2.batchSize)
        except Exception as e:          # noqa: BLE001 - a rank refused
            error = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
        for route in routes:
            d = os.path.join(base, route)
            got = [torch.load(os.path.join(d, f)) for f in sorted(
                os.listdir(d))] if os.path.isdir(d) else []
            lead = next((g for g in got if g["rank"] == 0), None)
            row = {"row": route, "free_gb": entry,
                   "caught": [g["caught"] for g in got],
                   "refused": [g["refused"].splitlines()[0]
                               if g["refused"] else None for g in got],
                   "finished": [g["finished"] for g in got],
                   "peak_reserved_gb": [g["allocator"]["max_reserved_bytes"]
                                        / 1e9 for g in got],
                   "launch_error": error, "s": time.perf_counter() - t0}
            if lead is not None and lead["deltas"] is not None:
                row["err_over_tol"] = {
                    m: delta_ratio(lead["deltas"][m], ref[m],
                                   cs.PAR_SCALE_TOL, cs.PAR_TENSOR_TOL)["ratio"]
                    for m in ref}
            print(f"[graph_memory_probe] route {json.dumps(row)}", flush=True)
            for g in got:
                if g["refused"]:
                    print(f"[graph_memory_probe] rank {g['rank']} {route} "
                          f"refusal:\n{g['refused']}", flush=True)
            rows.append(row)
    return rows


# N, C, H = W, k of a float32 conv whose first cuDNN plan asks 9.20 GB of
# workspace on the H100 (heuristic mode, TF32 off); the fallback fits in
# a few MB
CONV = (8, 128, 128, 5)
CONV_MARGIN = 256 << 20             # bytes the blocker leaves beyond the tensors


def blocked_capture(torch, dev, conv=CONV, margin=CONV_MARGIN, seed=0):
    """The refusal on the card: a conv closure's graphs.Program captured
    while a blocking tensor leaves the card ``margin`` bytes beyond the
    capture's input and output (less than the first plan's workspace),
    then, the blocker freed, the same closure at batch N + 1 (a shape
    the plan cache has not seen). Returns the refusal's message (None if
    none came), the line of the conv the message must name, the free
    bytes the blocker left, the clean capture's caught count, whether its
    replay is bit-equal to the eager call, and the seconds."""
    import torch.nn.functional as F
    from neural_human_video_rendering_tpu_torch.train import graphs
    t0 = time.perf_counter()
    n, c, hw, k = conv
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(c, c, k, k, device=dev, generator=g) * 0.02
    xs = [torch.randn(b, c, hw, hw, device=dev, generator=g)
          for b in (n, n + 1)]

    def make(st):
        return lambda: F.conv2d(st["x"], w, padding=k // 2)

    line = f"{os.path.basename(__file__)}:{make.__code__.co_firstlineno + 1}"
    prog = graphs.Program("blocked_conv", dev)
    out = {"conv": list(conv), "conv_line": line, "refusal": None}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False), \
            torch.inference_mode():
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info(dev)[0]
        need = 2 * xs[0].numel() * 4           # the static input, the output
        block = torch.empty(free - need - margin, dtype=torch.uint8,
                            device=dev)
        out["free_left_bytes"] = torch.cuda.mem_get_info(dev)[0]
        try:
            prog("k", {"x": xs[0]}, make)
        except graphs.CaughtOutOfMemory as e:
            out["refusal"] = str(e)
        out["entries_after_refusal"] = len(prog.entries)
        del block
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        got = prog("k", {"x": xs[1]}, make)
        again = prog("k", {"x": xs[1]}, make)        # a replay
        want = F.conv2d(xs[1], w, padding=k // 2)
        torch.cuda.synchronize(dev)
    out.update(clean_num_ooms=prog.num_ooms, captures=prog.captures,
               bit_equal=bool(torch.equal(got, want)
                              and torch.equal(again, want)),
               s=time.perf_counter() - t0)
    del xs, got, again, want, prog
    torch.cuda.empty_cache()
    return out


def region_us(torch, dev, n=2000):
    """The host cost of one graphs.refuse_caught_ooms region on the card
    (the eager step's check a call), in microseconds."""
    from neural_human_video_rendering_tpu_torch.train import graphs
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        with graphs.refuse_caught_ooms("cost", dev, "an empty region"):
            pass
    return (time.perf_counter() - t0) / n * 1e6


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
    ap.add_argument("--routes", action="store_true",
                    help="at each --free_gb entry, rows (i) graphed, (ii) "
                         "recaptured and (iii) eager instead of "
                         "selfcheck's rank")
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
        if a.routes:
            out += route_rows(torch, sc, cs, launch, o2, batch, atlas, bg,
                              threads, work, entry)
            del filler
            torch.cuda.empty_cache()
            continue
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
            row["refused"] = {}
            for f in sorted(os.listdir(ranks)) if os.path.isdir(ranks) else []:
                if f.startswith("refused"):
                    with open(os.path.join(ranks, f)) as fh:
                        row["refused"][f[7:-4]] = fh.readline().strip()
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
