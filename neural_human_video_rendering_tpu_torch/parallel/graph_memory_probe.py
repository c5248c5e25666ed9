#!/usr/bin/env python3
"""Phase 12(a)'s check with the ranks on the graphed route, as the card's
free memory shrinks:

    python3 neural_human_video_rendering_tpu_torch/parallel/graph_memory_probe.py

chip_smoke's phase 12(a) setting (its TRAIN and PAR_EXACT flags: the
flagship widths in float32, SGD(1), one global batch of 2): the two
ranks as eager threads of this process (the reference), then two gloo
ranks sharing cuda:0 on make_train_step's graphed route, once with the
card as it is and then with this process holding all but 45 / 30 / 22
GB of it. For each it prints the ranks' err/tol against the threads in
the parity tests' form and each rank's caught out-of-memory count and
peak reservation (``torch.cuda.memory_stats``): cuDNN's plan search
takes another algorithm when the allocator refuses a plan's workspace.
Exits non-zero without a CUDA card.
"""

import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FREE_GB = (None, 45, 30, 22)          # None: the card as it is


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


def main() -> int:
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
    threads = os.path.join(work, "threads")
    sc.thread_ranks(o2, batch, atlas, bg, threads, 1, 2, dev)
    torch.cuda.empty_cache()
    out = []
    for free_gb in FREE_GB:
        filler = None
        if free_gb is not None:
            free = torch.cuda.mem_get_info(dev)[0] / 1e9
            filler = torch.empty(int((free - free_gb) * 1e9),
                                 dtype=torch.uint8, device=dev)
        ranks = os.path.join(work, f"ranks_free_{free_gb}")
        t0 = time.perf_counter()
        row = {"free_gb": free_gb}
        try:
            launch(rank_probe, o2, batch, atlas, bg, ranks, 1, where=work,
                   batch=o2.batchSize)
            got = sc.compare(threads, ranks, cs.PAR_SCALE_TOL,
                             cs.PAR_TENSOR_TOL)
            row.update({"err_over_tol": {m: r["ratio"] for m, r in
                                         got["delta_ratio"].items()},
                        "loss_max_rel": got["loss_max_rel"]})
        except Exception as e:          # noqa: BLE001 - a rank ran out
            row["error"] = f"{type(e).__name__}: {str(e)[:200]}"
        row["s"] = time.perf_counter() - t0
        print(f"[graph_memory_probe] {json.dumps(row)}", flush=True)
        out.append(row)
        del filler
        torch.cuda.empty_cache()
    print(json.dumps({"graph_memory_probe": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
