"""PyTorch port, data parallel (``parallel/mesh.py``, ``runtime.py``)
against the JAX package's data mesh, on CPU ranks over gloo.

Two process groups of two CPU ranks each (``runtime.launch`` with
``--gpu_ids=-1,-1``: spawned processes, one intra-op thread each, a
``file://`` rendezvous under the test's tmp dir):
  * the steps: the stage-2 step (``--temporal_prev fake`` and ``real``)
    and the stage-1 UV step, each rank on its 2 rows of a global batch of
    4, against the JAX package's jitted steps on a ``make_mesh(4)`` with
    the batch sharded, the same weights, SGD(1) on both sides. One sample
    of the batch has no foreground (its DensePose parts and mask zeroed),
    so the two ranks' masked counts differ; the same ranks with each
    masked mean divided by its local count (a plain average of the local
    ratios) must miss the tolerance. Then the image pool (--pool_size 4,
    JAX's pool_query draws fed in) over 4 steps against one rank;
  * the drivers: run_train on a real-format corpus on 2 ranks (one
    metrics.jsonl writer, the checkpoints equal to every rank's state),
    resumed on 1 rank, then on 2 again (the same start epoch and step as
    a straight run), the held-out eval on 2 ranks against 1, and
    run_inference on 2 ranks against 1 (batch 3 rounded up to 4).
Without a group: the masked losses split in halves against JAX's on the
whole batch, BatchLoader's shards against JAX's, and the launch rules.

Tolerances: the losses 1e-5 relative and the parameter changes as
``test_torch_port_train_step._assert_deltas`` (the sums of the ranks run
in another order than XLA's); the pool's D inputs and entries 1e-5
(fakes of a batch of 1 against a batch of 2: float32 rounding) with the
same slots filled and swapped; val_PSNR / val_SSIM 1e-6 relative (float32
per-sample values of batches of 1 against a batch of 2, summed in float64;
measured 4.7e-8); frames within 1 uint8 level.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neural_human_video_rendering_tpu.config import Options as JOptions
from neural_human_video_rendering_tpu.data import dataset as jds
from neural_human_video_rendering_tpu.losses import recon as jrecon
from neural_human_video_rendering_tpu.losses import temporal as jtemporal
from neural_human_video_rendering_tpu.models import generators as jg
from neural_human_video_rendering_tpu.parallel.mesh import (make_mesh,
                                                            replicate,
                                                            shard_batch)
from neural_human_video_rendering_tpu.train import state as jstate
from neural_human_video_rendering_tpu.train import steps as jsteps
from neural_human_video_rendering_tpu_torch import losses as TL
from neural_human_video_rendering_tpu_torch import runtime
from neural_human_video_rendering_tpu_torch.config import Options as TOptions
from neural_human_video_rendering_tpu_torch.config import \
    TestOptions as PortTestOptions
from neural_human_video_rendering_tpu_torch.config import TrainOptions
from neural_human_video_rendering_tpu_torch.data import dataset as tds
from neural_human_video_rendering_tpu_torch.infer import test_driver as td
from neural_human_video_rendering_tpu_torch.models import generators as tg
from neural_human_video_rendering_tpu_torch.models.bridge import params_from_jax
from neural_human_video_rendering_tpu_torch.parallel import selfcheck as sc
from neural_human_video_rendering_tpu_torch.parallel.mesh import DataParallel
from neural_human_video_rendering_tpu_torch.train import drivers
from neural_human_video_rendering_tpu_torch.train import state as tstate
from neural_human_video_rendering_tpu_torch.train import steps as tsteps
from neural_human_video_rendering_tpu_torch.train.state import PretrainState
from neural_human_video_rendering_tpu_torch.utils import checkpoint as ckpt
from neural_human_video_rendering_tpu_torch.utils.image import read_png
from test_torch_port_pretrain import TINY, write_port_corpus
from test_torch_port_train_step import (LOSS_RTOL, STEP_FLAGS, _assert_deltas,
                                        _linear_atlas, _np_tree)

CPU = torch.device("cpu")
# frames whose joints and whose predecessors' joints are unclipped at
# 32 px (ROADMAP hazard 7); not frame 0, whose t-1 is itself: its
# --temporal_prev fake error is exactly 0 where JAX's L1 gradient is 1 and
# torch's 0 (hazard 6)
FRAMES = (1, 11, 1, 11)
EMPTY = 1                   # the sample with no foreground: rank 0's half
POOL_STEPS = 4
SC_ADAM = 1                 # parallel.selfcheck's Adam steps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread here (the spawned ranks take the parent's count
    split over them, so one as well)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_ranks(tmp, **flags):
    """Options that spawn two CPU ranks, rendezvous under tmp."""
    return TOptions(**flags, gpu_ids="-1,-1", checkpoints_dir=str(tmp))


def _tensors(sd):
    return {k: v.detach().clone() for k, v in sd.items()}


# ----------------------------------------------------------------------
# group 1: the steps against the JAX mesh, and the pool
# ----------------------------------------------------------------------

def _global_batch(jopt):
    ds = jds.SyntheticDataset(jopt, length=12)
    batch = jds.collate([ds[i] for i in FRAMES])
    batch["dp_parts"][EMPTY] = 0
    batch["mask"][EMPTY] = 0
    return ds, batch


def _stage2_case(temporal_prev):
    """JAX's stage-2 step on make_mesh(4), the batch sharded: its weights
    before, the batch, its losses and its weights after (torch names)."""
    flags = dict(STEP_FLAGS, batchSize=4, temporal_prev=temporal_prev)
    jopt = JOptions(**flags, use_pallas_warp=False)
    ds, batch = _global_batch(jopt)
    atlas, bg = _linear_atlas(), ds.background()
    bundle = jstate.create_train_state(jopt, jax.random.PRNGKey(0), atlas, bg)
    g0 = _np_tree(bundle["state"].g_params)
    head = max(k for k in g0["TexG"]["GlobalGenerator_0"]
               if k.startswith("ConvNormRelu_"))
    g0["TexG"]["GlobalGenerator_0"][head]["Conv_0"]["kernel"][...] = 0.0
    d0 = _np_tree(bundle["state"].d_params)
    sgd = optax.sgd(1.0)
    mesh = make_mesh(4)
    jst0 = replicate(mesh, bundle["state"].replace(
        g_params=jax.tree.map(jnp.asarray, g0),
        d_params=jax.tree.map(jnp.asarray, d0),
        g_ema=jax.tree.map(jnp.asarray, g0),
        g_opt=sgd.init(g0), d_opt=sgd.init(d0)))
    jstep = jsteps.make_train_step(jopt, bundle["renderer"], bundle["disc"],
                                   None, sgd, sgd)
    jst1, jm = jstep(jst0, shard_batch(mesh, batch))
    return {"flags": flags, "batch": batch, "atlas": atlas, "bg": bg,
            "G0": params_from_jax(g0), "D0": params_from_jax(d0),
            "losses": {k: float(v) for k, v in jm.items()},
            "G": params_from_jax(_np_tree(jst1.g_params)),
            "D": params_from_jax(_np_tree(jst1.d_params)),
            "EMA": params_from_jax(_np_tree(jst1.g_ema))}


def _uv_case():
    """JAX's stage-1 UV step on make_mesh(4), the batch sharded."""
    flags = dict(STEP_FLAGS, batchSize=4)
    jopt = JOptions(**flags)
    _, batch = _global_batch(jopt)
    S = jopt.loadSize
    jt = jg.TransG(jopt.n_parts, jopt.ngf, jopt.n_downsample_translate,
                   jopt.n_blocks_translate, stem_s2d=2, head_s2d=2,
                   pad_mode="same", dtype=jnp.float32)
    pose_nc = TOptions(**flags).pose_nc
    p0 = _np_tree(jt.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, S, S, pose_nc)))["params"])
    sgd = optax.sgd(1.0)
    mesh = make_mesh(4)
    params = replicate(mesh, jax.tree.map(jnp.asarray, p0))
    p1, _, jm = jsteps.make_pretrain_uv_step(jopt, jt, sgd)(
        params, replicate(mesh, sgd.init(params)), shard_batch(mesh, batch))
    return {"flags": flags, "batch": batch, "W0": params_from_jax(p0),
            "losses": {k: float(v) for k, v in jm.items()},
            "W": params_from_jax(_np_tree(p1))}


def _pool_draws(B, K, steps, seed=7):
    """The draws of JAX's pool_query over `steps` queries from one key, in
    pool_draws' form (the key advances as pool_query advances it)."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        k_idx, k_coin, key = jax.random.split(key, 3)
        perm = (np.array(jax.random.permutation(k_idx, K), np.int64)
                if B <= K else None)
        out.append((np.array(jax.random.uniform(k_idx, (B,))), perm,
                    np.array(jax.random.uniform(k_coin, (B,)))))
    return out


def _pool_case():
    flags = dict(STEP_FLAGS, batchSize=2, pool_size=4, temporal_prev="real")
    jopt = JOptions(**flags)
    ds = jds.SyntheticDataset(jopt, length=12)
    pairs = [(1, 11), (11, 1), (1, 1), (11, 11)]
    return {"flags": flags, "atlas": _linear_atlas(), "bg": ds.background(),
            "batches": [jds.collate([ds[i] for i in p]) for p in pairs],
            "draws": _pool_draws(2, 4, POOL_STEPS)}


def _local_counts(dp):
    """``dp`` whose masked means divide by the local count: the plain
    average of the ranks' local ratios, the fault the test must catch."""
    dp = dataclasses.replace(dp)
    dp.count_share = lambda c: torch.clamp(c, min=1.0)
    return dp


def _port_stage2(case, dp):
    topt = TOptions(**case["flags"], gpu_ids="-1")
    st = tstate.create_train_state(topt, case["atlas"], case["bg"],
                                   device=CPU)
    st.renderer.load_state_dict(case["G0"])
    st.disc.load_state_dict(case["D0"])
    st.g_ema = {k: v.detach().clone()
                for k, v in st.renderer.named_parameters()}
    step = tsteps.make_train_step(
        topt, st.renderer, st.disc, None,
        torch.optim.SGD(st.renderer.parameters(), lr=1.0),
        torch.optim.SGD(st.disc.parameters(), lr=1.0), dp)
    losses = {k: float(v) for k, v in step(st, dp.shard_batch(case["batch"])
                                           ).items()}
    return {"losses": losses, "G": _tensors(st.renderer.state_dict()),
            "D": _tensors(st.disc.state_dict()), "EMA": _tensors(st.g_ema)}


def _port_uv(case, dp):
    topt = TOptions(**case["flags"], gpu_ids="-1")
    with torch.device("meta"):
        net = tg.TransG(topt.pose_nc, topt.n_parts, topt.ngf,
                        topt.n_downsample_translate, topt.n_blocks_translate,
                        stem_s2d=2, head_s2d=2, pad_mode="same")
    net.to_empty(device="cpu")
    net.load_state_dict(case["W0"])
    st = PretrainState(step=0, net=net, device=CPU,
                       optimizer=torch.optim.SGD(net.parameters(), lr=1.0))
    losses = tsteps.make_pretrain_uv_step(topt, net, st.optimizer, dp)(
        st, dp.shard_batch(case["batch"]))
    return {"losses": {k: float(v) for k, v in losses.items()},
            "W": _tensors(net.state_dict())}


def _port_pool(case, dp):
    """POOL_STEPS stage-2 steps with the pool, JAX's draws fed in, the
    weights held: each step's D fake input (this rank's rows) and the pool
    at the end."""
    topt = TOptions(**case["flags"], gpu_ids="-1")
    st = tstate.create_train_state(topt, case["atlas"], case["bg"],
                                   device=CPU, dp=dp)
    # the weights held (SGD, lr 0): a training step amplifies the rounding
    # of a batch of 1 against a batch of 2 about tenfold a step, and the
    # pool's semantics do not need the weights to move
    opts = [torch.optim.SGD(m.parameters(), lr=0.0)
            for m in (st.renderer, st.disc)]
    draws = iter(case["draws"])
    real_draws = tsteps.pool_draws
    tsteps.pool_draws = lambda gen, B, K: tuple(
        None if a is None else torch.from_numpy(a) for a in next(draws))
    seen = []
    hook = st.disc.register_forward_pre_hook(
        lambda m, args: seen.append(args[0].detach().clone()))
    try:
        step = tsteps.make_train_step(topt, st.renderer, st.disc, None,
                                      *opts, dp)
        d_inputs = []
        for b in case["batches"]:
            step(st, dp.shard_batch(b))
            d_inputs.append(seen[-1])       # D's last call: the fake input
    finally:
        hook.remove()
        tsteps.pool_draws = real_draws
    return {"d_inputs": d_inputs, "pool": st.pool_buf.clone(),
            "pool_n": int(st.pool_n)}


def _steps_rank(opt, out, dp=None):
    """One rank of group 1: every case on this rank's rows."""
    cases = torch.load(os.path.join(out, "cases.pt"), weights_only=False)
    res = {"fake": _port_stage2(cases["fake"], dp),
           "real": _port_stage2(cases["real"], dp),
           "real_local": _port_stage2(cases["real"], _local_counts(dp)),
           "uv": _port_uv(cases["uv"], dp),
           "pool": _port_pool(cases["pool"], dp)}
    sc.rank_step(*_selfcheck_args(cases["fake"]), os.path.join(out, "sc_ranks"),
                 SC_ADAM, dp=dp)
    torch.save(res, os.path.join(out, f"steps_rank{dp.rank}.pt"))


def _selfcheck_args(case):
    """parallel.selfcheck's (opt, batch, atlas, bg) of the stage-2 case."""
    return (TOptions(**case["flags"], gpu_ids="-1"), case["batch"],
            case["atlas"], case["bg"])


@pytest.fixture(scope="module")
def steps_run(tmp_path_factory):
    """The JAX references, then the two ranks (one process group)."""
    tmp = tmp_path_factory.mktemp("steps")
    cases = {"fake": _stage2_case("fake"), "real": _stage2_case("real"),
             "uv": _uv_case(), "pool": _pool_case()}
    torch.save(cases, tmp / "cases.pt")
    runtime.launch(_steps_rank, _cpu_ranks(tmp), str(tmp), where=str(tmp),
                   batch=2)
    ranks = [torch.load(tmp / f"steps_rank{r}.pt") for r in (0, 1)]
    sc.thread_ranks(*_selfcheck_args(cases["fake"]), str(tmp / "sc_threads"),
                    SC_ADAM, 2, CPU)
    cases["selfcheck"] = sc.compare(str(tmp / "sc_threads"),
                                    str(tmp / "sc_ranks"))
    return cases, ranks


def _assert_ranks_equal(ranks, key, names):
    for name in names:
        a, b = ranks[0][key][name], ranks[1][key][name]
        for k in a:
            assert torch.equal(a[k], b[k]), f"{key} {name} {k}: ranks differ"


@pytest.mark.parametrize("mode", ["fake", "real"])
def test_two_ranks_match_the_jax_mesh_step(steps_run, mode):
    cases, ranks = steps_run
    case, got = cases[mode], ranks[0][mode]
    _assert_ranks_equal(ranks, mode, ("G", "D", "EMA"))
    assert ranks[0][mode]["losses"] == ranks[1][mode]["losses"]
    assert sorted(got["losses"]) == sorted(case["losses"])
    for k, v in case["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=LOSS_RTOL,
                                   err_msg=k)
    for m in ("G", "D", "EMA"):
        before = case["G0"] if m != "D" else case["D0"]
        _assert_deltas(m, got[m], case[m], before)


def test_selfcheck_reference_of_the_ranks_own_shapes(steps_run):
    """parallel.selfcheck's reference, the two ranks as threads of this
    process at their own shapes (thread_ranks), against the two gloo
    ranks of the fixture: the losses within 1e-5 relative and each
    module's change within the parity tests' form at its first term of
    1e-5 (compare's defaults, which chip_smoke phase 12(a) uses too)."""
    got = steps_run[0]["selfcheck"]
    assert got["n_rank_files"] == 2 and got["same_loss_keys"]
    assert got["ranks_bit_equal"]
    assert got["loss_max_rel"] <= 1e-5, got
    for m, r in got["delta_ratio"].items():
        assert r["ratio"] <= 1.0, (m, r)


def test_local_averaging_misses_the_jax_step(steps_run):
    """The fixture catches the fault it is there for: divided by local
    counts, the ranks' mean G_UV and G_Temp leave LOSS_RTOL and the
    gradients leave _assert_deltas, while the correct split passed."""
    cases, ranks = steps_run
    case, bad = cases["real"], ranks[0]["real_local"]
    batch = case["batch"]
    fg = (batch["dp_parts"] > 0).reshape(4, -1).sum(1)
    assert fg[EMPTY] == 0 and fg[:2].sum() != fg[2:].sum()
    rel = abs(bad["losses"]["G_UV"] - case["losses"]["G_UV"]) / abs(
        case["losses"]["G_UV"])
    assert rel > 100 * LOSS_RTOL, rel
    with pytest.raises(AssertionError):
        _assert_deltas("G", bad["G"], case["G"], case["G0"])


def test_two_ranks_match_the_jax_mesh_uv_pretrain_step(steps_run):
    cases, ranks = steps_run
    case, got = cases["uv"], ranks[0]["uv"]
    _assert_ranks_equal(ranks, "uv", ("W",))
    assert sorted(got["losses"]) == sorted(case["losses"]) == [
        "Prob", "UV", "total"]
    for k, v in case["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=LOSS_RTOL,
                                   err_msg=k)
    _assert_deltas("TransG", got["W"], case["W"], case["W0"])


def test_pool_on_two_ranks_matches_one(steps_run):
    cases, ranks = steps_run
    one = _port_pool(cases["pool"], DataParallel())
    two = [r["pool"] for r in ranks]
    assert torch.equal(two[0]["pool"], two[1]["pool"])
    assert two[0]["pool_n"] == two[1]["pool_n"] == one["pool_n"] == 4
    np.testing.assert_allclose(two[0]["pool"].numpy(), one["pool"].numpy(),
                               atol=1e-5)
    for s in range(POOL_STEPS):
        both = torch.cat([two[0]["d_inputs"][s], two[1]["d_inputs"][s]])
        np.testing.assert_allclose(both.numpy(), one["d_inputs"][s].numpy(),
                                   atol=1e-5, err_msg=f"step {s}")
    # the pool is full after 2 steps; a coin below 1/2 after that plays a
    # history entry back (drawn over the global batch's lanes)
    assert any((d[2] < 0.5).any() for d in cases["pool"]["draws"][2:])


# ----------------------------------------------------------------------
# group 2: the drivers and inference
# ----------------------------------------------------------------------

def _corpus_argv(tmp):
    c = str(tmp / "corpus")
    d = write_port_corpus(c, TrainOptions().parse(TINY, save=False))
    data = ["--pose_path", d["kp"], "--mask_path", d["mask"],
            "--densepose_path", d["dp"], "--img_path", d["frames"],
            "--flow_path", d["flow"], "--flow_inv_path", d["flow_inv"],
            "--bg_path", f"{c}/bg.png", "--texture_path", f"{c}/texture.png",
            "--checkpoints_dir", str(tmp / "ckpt")]
    train = [a for a in TINY if a not in ("--gpu_ids", "-1")] + data + [
        "--name", "e2e", "--batchSize", "2", "--data_ratio", "0.8",
        "--ema_decay", "0.999", "--lambda_L2", "500", "--lambda_UV", "1000",
        "--lambda_Prob", "10", "--lambda_Temp", "500", "--use_densepose_loss",
        "--temporal_prev", "real", "--no_decay", "--display_freq", "2"]
    infer = [a for a in TINY if a not in ("--gpu_ids", "-1")] + [
        "--pose_path", d["kp"], "--bg_path", f"{c}/bg.png",
        "--texture_path", f"{c}/texture.png", "--checkpoints_dir",
        str(tmp / "ckpt"), "--name", "e2e", "--which_epoch", "3",
        "--infer_batch", "3"]
    return train, infer


def _record(st, dp):
    return {"start_epoch": st.start_epoch, "step": st.step,
            "g_count": st.g_opt.count,
            "checksum": dp.check("state", st.tensors())}


def _drivers_rank(opt, spec, dp=None):
    """One rank of group 2: 2 ranks -> 1 rank -> 2 ranks of run_train,
    the eval and inference on 2 ranks and (rank 0) on 1."""
    train, infer, out = spec["train"], spec["infer"], spec["out"]
    solo = DataParallel()

    def run(extra, d):
        return drivers.run_train(TrainOptions().parse(
            train + extra + ["--gpu_ids", "-1"], save=d.is_lead), dp=d)

    rec = {"two_1": _record(run(["--niter", "1"], dp), dp)}
    with open(os.path.join(opt.run_dir, "metrics.jsonl")) as f:
        rec["metrics_after_1"] = [json.loads(line) for line in f]
    dp.barrier()
    if dp.is_lead:
        rec["one_2"] = _record(run(["--niter", "2", "--continue_train"],
                                   solo), solo)
    dp.barrier()
    st = run(["--niter", "3", "--continue_train"], dp)
    rec["two_3"] = _record(st, dp)
    saved = ckpt.load_net(opt.run_dir, "G", 3)
    rec["saved_G_is_state"] = all(torch.equal(v, saved[k]) for k, v in
                                  st.renderer.state_dict().items())
    topt = TrainOptions().parse(train + ["--niter", "3", "--gpu_ids", "-1"],
                                save=False)
    rec["eval_two"] = drivers._eval_fn(topt, dp)(st, 3)
    if dp.is_lead:
        rec["eval_one"] = drivers._eval_fn(topt, solo)(st, 3)

    def infer_opt(res):
        return PortTestOptions().parse(infer + ["--gpu_ids", "-1",
                                            "--results_dir", res], save=False)
    rec["frames_two"] = td.run_inference(infer_opt(spec["res_two"]), dp=dp)
    if dp.is_lead:
        rec["frames_one"] = td.run_inference(infer_opt(spec["res_one"]),
                                             dp=solo)
    torch.save(rec, os.path.join(out, f"drivers_rank{dp.rank}.pt"))


@pytest.fixture(scope="module")
def drivers_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("drivers")
    train, infer = _corpus_argv(tmp)
    opt = TrainOptions().parse(train + ["--gpu_ids=-1,-1"], save=False)
    spec = {"train": train, "infer": infer, "out": str(tmp),
            "res_two": str(tmp / "res_two"), "res_one": str(tmp / "res_one")}
    runtime.launch(_drivers_rank, opt, spec, where=str(tmp), batch=2)
    ranks = [torch.load(tmp / f"drivers_rank{r}.pt") for r in (0, 1)]
    return tmp, opt, spec, ranks


def test_run_train_two_ranks_one_writer_and_resume(drivers_run):
    """8 training frames, global batch 2: 4 steps an epoch on 2 ranks (1
    sample each) and on 1; resumed 2 -> 1 -> 2 at the straight run's epoch
    and step; the checkpoints are every rank's state."""
    tmp, opt, _, ranks = drivers_run
    for r in ranks:
        assert r["two_1"]["start_epoch"] == 1 and r["two_1"]["step"] == 4
        assert r["two_3"]["start_epoch"] == 3 and r["two_3"]["step"] == 12
        assert r["two_3"]["g_count"] == 12
        assert r["saved_G_is_state"]
    assert ranks[0]["one_2"] == {**ranks[0]["one_2"], "start_epoch": 2,
                                 "step": 8, "g_count": 8}
    for k in ("two_1", "two_3"):
        assert ranks[0][k]["checksum"] == ranks[1][k]["checksum"]
    # one writer: 4 loss records and 1 eval record an epoch
    first = ranks[0]["metrics_after_1"]
    assert [(m["epoch"], m["it"]) for m in first] == [
        (1, 0), (1, 1), (1, 2), (1, 3), (1, -1)]
    with open(os.path.join(opt.run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [m["epoch"] for m in recs] == [e for e in (1, 2, 3)
                                          for _ in range(5)]
    assert {"3_net_G.pth", "3_net_G_ema.pth", "latest_state.pth"} <= set(
        os.listdir(opt.run_dir))
    assert not [f for f in os.listdir(opt.run_dir) if "rendezvous" in f]


def test_val_psnr_on_two_ranks_equals_one(drivers_run):
    _, _, _, ranks = drivers_run
    one, two = ranks[0]["eval_one"], ranks[0]["eval_two"]
    assert ranks[1]["eval_two"] == two
    assert sorted(two) == ["val_PSNR", "val_SSIM"]
    for k in two:
        np.testing.assert_allclose(two[k], one[k], rtol=1e-6, err_msg=k)


def test_sharded_inference_writes_one_ranks_frames(drivers_run):
    _, _, spec, ranks = drivers_run
    assert ranks[0]["frames_two"] == ranks[1]["frames_two"] == \
        ranks[0]["frames_one"] == 10
    names = sorted(os.listdir(os.path.join(spec["res_one"], "images")))
    assert names == sorted(os.listdir(os.path.join(spec["res_two"],
                                                   "images")))
    assert len(names) == 10
    for n in names:
        a = read_png(os.path.join(spec["res_one"], "images", n)).astype(int)
        b = read_png(os.path.join(spec["res_two"], "images", n)).astype(int)
        assert np.abs(a - b).max() <= 1, n
    html = open(os.path.join(spec["res_two"], "index.html")).read()
    assert all(f"images/{n}" in html for n in names)


# ----------------------------------------------------------------------
# without a process group
# ----------------------------------------------------------------------

def _loss_inputs(seed=0, B=4, H=8, W=8, P=24):
    rng = np.random.default_rng(seed)
    parts = rng.integers(0, P + 1, (B, H, W))
    parts[EMPTY] = 0
    parts[2, :4] = 0
    flow = rng.standard_normal((B, H, W, 2)).astype(np.float32)
    flow[EMPTY] *= 8            # inconsistent with flow_inv: few kept
    return {"uv": rng.random((B, H, W, P, 2), np.float32),
            "logits": rng.standard_normal((B, H, W, P + 1)).astype(np.float32),
            "dp_uv": rng.random((B, H, W, 2), np.float32),
            "parts": parts.astype(np.int32),
            "mask": (parts > 0)[..., None].astype(np.float32),
            "cur": rng.standard_normal((B, H, W, 3)).astype(np.float32),
            "prev": rng.standard_normal((B, H, W, 3)).astype(np.float32),
            "flow": flow,
            "flow_inv": rng.standard_normal((B, H, W, 2)).astype(np.float32)}


def _nchw(a, rows):
    t = torch.from_numpy(np.ascontiguousarray(a[rows]))
    return t.permute(0, 3, 1, 2) if t.dim() == 4 else t


LOSSES = {
    "uv": (lambda x, s, c: TL.uv_loss(
        torch.from_numpy(x["uv"][s]).permute(0, 3, 4, 1, 2),
        _nchw(x["dp_uv"], s), torch.from_numpy(x["parts"][s]), c),
        lambda x: jrecon.uv_loss(x["uv"], x["dp_uv"], x["parts"])),
    "uv_grad": (lambda x, s, c: TL.uv_grad_loss(
        torch.from_numpy(x["uv"][s]).permute(0, 3, 4, 1, 2),
        _nchw(x["dp_uv"], s), torch.from_numpy(x["parts"][s]), c),
        lambda x: jrecon.uv_grad_loss(x["uv"], x["dp_uv"], x["parts"])),
    "part_ce_masked": (lambda x, s, c: TL.part_ce_loss(
        _nchw(x["logits"], s), torch.from_numpy(x["parts"][s]),
        _nchw(x["mask"], s), c),
        lambda x: jrecon.part_ce_loss(x["logits"], x["parts"], x["mask"])),
    "temporal": (lambda x, s, c: TL.temporal_flow_loss(
        _nchw(x["cur"], s), _nchw(x["prev"], s), _nchw(x["flow"], s),
        _nchw(x["flow_inv"], s), c),
        lambda x: jtemporal.temporal_flow_loss(x["cur"], x["prev"],
                                               x["flow"], x["flow_inv"])),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_masked_loss_halves_average_to_the_jax_global_loss(name):
    """Each half with ``count`` = max(global count, 1) / 2 (the count of
    the whole batch, computed here as the ranks' all_reduce would): the
    mean of the two halves is JAX's loss on the whole batch, and the plain
    mean of the halves' own ratios is not."""
    port, jax_fn = LOSSES[name]
    x = _loss_inputs()
    halves = (slice(0, 2), slice(2, 4))
    counts = []
    port(x, halves[0], lambda c: counts.append(c) or torch.ones(()))
    port(x, halves[1], lambda c: counts.append(c) or torch.ones(()))
    total = counts[0] + counts[1]

    def share(c):
        return torch.clamp(total, min=1.0) / 2

    got = np.mean([float(port(x, h, share)) for h in halves])
    local = np.mean([float(port(x, h, None)) for h in halves])
    want = float(jax_fn({k: jnp.asarray(v) for k, v in x.items()}))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert abs(local - want) > 1e-3 * abs(want)


def test_ms_iuv_loss_takes_the_count():
    x = _loss_inputs(1, H=16, W=16)
    aux = [(_nchw(x["logits"], slice(0, 4))[:, :, ::2, ::2],
            torch.from_numpy(x["uv"]).permute(0, 3, 4, 1, 2)[..., ::2, ::2])]
    args = (torch.from_numpy(x["dp_uv"]).permute(0, 3, 1, 2),
            torch.from_numpy(x["parts"]), _nchw(x["mask"], slice(0, 4)))
    seen = []
    uv, ce = TL.ms_iuv_loss(aux, *args, count=lambda c: seen.append(c) or
                            torch.clamp(c, min=1.0))
    ref = TL.ms_iuv_loss(aux, *args)
    assert len(seen) == 2
    assert float(uv) == float(ref[0]) and float(ce) == float(ref[1])


class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"index": np.int64(i)}


@pytest.mark.parametrize("count", [1, 2, 3])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_shards_match_jax(count, shuffle):
    """BatchLoader(shard=(i, n)) reads JAX's BatchLoader's samples in its
    order over two epochs; every shard reports floor(N / n) // batch
    batches."""
    ds, bs = _Indexed(23), 2
    for i in range(count):
        ours = tds.BatchLoader(ds, bs, shuffle=shuffle, seed=4,
                               shard=(i, count))
        ref = jds.BatchLoader(ds, bs, shuffle=shuffle, seed=4,
                              shard=(i, count))
        assert len(ours) == len(ref) == (23 // count) // bs
        for _ in range(2):
            got = [b["index"].tolist() for b in ours]
            want = [b["index"].tolist() for b in ref]
            assert got == want and len(got) == len(ours)


def test_shards_cover_the_epoch_once():
    ds = _Indexed(20)
    seen = sorted(int(i) for r in range(4) for b in tds.BatchLoader(
        ds, 5, seed=1, shard=(r, 4)) for i in b["index"])
    assert seen == list(range(20))
    with pytest.raises(ValueError):
        tds.BatchLoader(ds, 2, shard=(2, 2))


def test_launch_rules(tmp_path, capsys, monkeypatch):
    """An indivisible batch runs one rank and says so (the JAX mesh's
    message); --mesh_shape caps the ranks; the CPU and cards do not mix;
    under torchrun a cap below the world and an indivisible batch are
    refused before any process group starts."""
    opt = _cpu_ranks(tmp_path, batchSize=3)
    assert runtime.plan_ranks(opt, 3) == [-1]
    assert "batchSize 3 not divisible by 2 ranks" in capsys.readouterr().out
    assert runtime.plan_ranks(opt) == [-1, -1]
    assert runtime.plan_ranks(dataclasses.replace(opt, mesh_shape="1"),
                              2) == [-1]
    assert runtime.plan_ranks(dataclasses.replace(
        opt, gpu_ids="0,1,2,3", mesh_shape="2,2"), 4) == [0, 1]
    with pytest.raises(ValueError, match="mixes"):
        runtime.gpu_id_list("0,-1")
    assert runtime.backend_for([0, 0]) == "gloo"
    assert runtime.backend_for([0, 1]) == "nccl"
    assert runtime.backend_for([-1, -1]) == "gloo"
    for k, v in (("WORLD_SIZE", "2"), ("RANK", "0"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="nproc_per_node 1"):
        runtime.init_distributed(dataclasses.replace(opt, mesh_shape="1"))
    with pytest.raises(ValueError, match="does not split"):
        runtime.init_distributed(opt, 3)


def test_one_rank_runs_in_process(tmp_path, capsys):
    """An indivisible batch and --mesh_shape 1 each keep the run in this
    process (run_train returns its state; no rank is spawned)."""
    base = [a for a in TINY if a not in ("--gpu_ids", "-1")] + [
        "--checkpoints_dir", str(tmp_path), "--niter", "1", "--no_decay"]
    st = drivers.run_train(TrainOptions().parse(
        base + ["--gpu_ids=-1,-1", "--batchSize", "3", "--name", "a"]),
        max_steps=1)
    assert st is not None and st.step == 1
    assert "not divisible by 2 ranks -> one rank" in capsys.readouterr().out
    st = drivers.run_train(TrainOptions().parse(
        base + ["--gpu_ids=-1,-1", "--mesh_shape", "1", "--name", "b"]),
        max_steps=1)
    assert st is not None and st.step == 1
    assert "[mesh]" not in capsys.readouterr().out


def test_launcher_script_under_torchrun_world_one(tmp_path, capsys,
                                                  monkeypatch):
    """A launcher script through launch.py in a torchrun process (its
    environment, a world of 1 over gloo on the CPU): the trainer runs as
    that rank, its collectives run, and the group is left at the end."""
    import torch.distributed as dist

    from neural_human_video_rendering_tpu_torch import launch
    script = tmp_path / "train_tiny.sh"
    script.write_text("#!/bin/bash\nNAME=${1:?name}\n"
                      "python3 train.py --name ${NAME} --batchSize 4 \\\n"
                      "  --niter 1 --no_decay\n")
    for k, v in (("WORLD_SIZE", "1"), ("RANK", "0"), ("LOCAL_RANK", "0"),
                 ("LOCAL_WORLD_SIZE", "1"), ("MASTER_ADDR", "127.0.0.1"),
                 ("MASTER_PORT", "0")):
        monkeypatch.setenv(k, v)
    assert launch.main([str(script), "tr", "--", *TINY,
                        "--checkpoints_dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "[mesh] rank 0 of 1 on cpu (gloo)" in out
    assert "[kernels] rank 0 of 1 on cpu (gloo) launches" in out
    loss = [ln for ln in out.splitlines() if ln.startswith("(epoch: 1, it")]
    assert len(loss) == 4 and not dist.is_initialized()
    assert os.path.isfile(tmp_path / "tr" / "1_net_G.pth")
    assert os.path.isfile(tmp_path / "tr" / "opt.txt")
