"""PyTorch port, the one dispatch of the captured programs
(``graphs.Dispatch``, ``train/graphs.py``) across its four callers: the
forward, the stage-2 step, a pretrain step and the served program, on the
CPU.

Each caller runs through ``graphs.StandIn`` (the ``stand_in`` fixture of
tests/test_torch_port_graph_step.py, which patches ``graphs.program_for``,
the one seam) and through the CPU's own route:
  * each route is printed once, however many calls take it;
  * a new object among those the graphs address drops the captures and
    captures anew;
  * the eager call beside the program (a step called with ``mark``; the
    forward's and the server's plain versions) runs eagerly: it captures
    nothing, and a step's says so once.
"""

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import pytest
import torch

from neural_human_video_rendering_tpu_torch import serve as srv
from neural_human_video_rendering_tpu_torch.config import Options as TOptions
from neural_human_video_rendering_tpu_torch.data import dataset as tds
from neural_human_video_rendering_tpu_torch.data.wire import pack_batch
from neural_human_video_rendering_tpu_torch.models.renderer import (
    init_params, renderer_from_options)
from neural_human_video_rendering_tpu_torch.train import state as tstate
from neural_human_video_rendering_tpu_torch.train import steps as tsteps
from test_torch_port_graph_pretrain import (FLAG_OPT, _batches,  # noqa: F401
                                            artifacts)
from test_torch_port_graph_step import (STEP_FLAGS, _assets,  # noqa: F401
                                        _linear_atlas, stand_in)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Caller(NamedTuple):
    name: str
    program: object
    call: Callable[[], object]
    # replaces one of the objects the graphs address
    swap: Callable[[], None]
    # the eager call beside the program
    eager: Callable[[], object]
    # the phases a step's eager call marked (None: no marks)
    marks: Optional[List[str]]


def _forward(tmp_path, artifacts):
    opt = TOptions(**dict(STEP_FLAGS, checkpoints_dir=str(tmp_path)),
                   gpu_ids="-1")
    ds = tds.SyntheticDataset(opt, length=2, seed=2)
    fwd = tsteps.make_forward_fn(
        opt, init_params(renderer_from_options(opt), 0).eval())
    assets = [_assets(ds)]
    joints = torch.from_numpy(np.stack([ds[0]["joints"], ds[1]["joints"]]))

    def swap():
        assets[0] = (assets[0][0].clone(), assets[0][1].clone(), None)

    return Caller("forward", fwd.program,
                  lambda: fwd(assets[0], joints)["fake"], swap,
                  lambda: fwd.eager(assets[0], joints)["fake"], None)


def _step(tmp_path, artifacts):
    opt = TOptions(**dict(STEP_FLAGS, checkpoints_dir=str(tmp_path)),
                   gpu_ids="-1")
    ds = tds.SyntheticDataset(opt, length=2, seed=1)
    st = tstate.create_train_state(opt, _linear_atlas(), ds.background(),
                                   device=CPU)
    step = tsteps.make_train_step(opt, st.renderer, st.disc, None, st.g_opt,
                                  st.d_opt)
    batch = pack_batch(tds.collate([ds[0], ds[1]]))
    marks: List[str] = []

    def swap():
        st.bg = st.bg.clone()

    return Caller("step", step.program, lambda: step(st, batch)["G_total"],
                  swap, lambda: step(st, batch, marks.append)["G_total"],
                  marks)


def _pretrain_uv(tmp_path, artifacts):
    net = init_params(renderer_from_options(FLAG_OPT), 1).TransG
    st = tstate.PretrainState(step=0, net=net, device=CPU,
                              optimizer=tstate.make_optimizer(
                                  FLAG_OPT, net.named_parameters(), 1))
    step = tsteps.make_pretrain_uv_step(FLAG_OPT, st.net, st.optimizer)
    batch = _batches(FLAG_OPT)[0][0]
    marks: List[str] = []

    def swap():                     # a resume: a new optimizer state
        st.optimizer.load_state_dict(st.optimizer.state_dict())

    return Caller("pretrain_uv", step.program,
                  lambda: step(st, batch)["total"], swap,
                  lambda: step(st, batch, marks.append)["total"], marks)


def _serve(tmp_path, artifacts):
    paths, joints = artifacts
    model = srv._Model(paths[False], CPU)      # the warm-up call: one call

    def swap():                     # other weights
        model.params = {k: v.clone() for k, v in model.params.items()}

    return Caller("serve", model.program, lambda: model.render(joints), swap,
                  lambda: model.forward(torch.from_numpy(joints)).numpy(),
                  None)


CALLERS = {"forward": _forward, "step": _step, "pretrain_uv": _pretrain_uv,
           "serve": _serve}


@pytest.mark.parametrize("caller", list(CALLERS))
def test_one_dispatch_routes_every_caller(caller, stand_in, artifacts,
                                          tmp_path, capsys):
    make = CALLERS[caller]
    # the CPU's own route: eager, said once
    with stand_in.cpu():
        c = make(tmp_path, artifacts)
    assert c.program is None
    c.call()
    c.call()
    printed = capsys.readouterr().err
    assert printed.count(f"[{c.name}] ") == 1
    assert printed.count(f"[{c.name}] eager (cpu)\n") == 1

    # the stand-in program: one capture, its route said once
    c = make(tmp_path, artifacts)
    assert c.program is stand_in[-1]
    first = c.call()
    again = c.call()
    assert c.program.captures == 1 and len(c.program.entries) == 1

    # the eager call beside it captures nothing
    for _ in range(2):
        got = c.eager()
    assert c.program.captures == 1
    if c.marks is None:             # the plain version: the graph's bits
        want = torch.as_tensor(np.asarray(again))
        assert torch.equal(torch.as_tensor(np.asarray(got)), want)
        assert torch.equal(torch.as_tensor(np.asarray(first)), want)
    else:
        assert c.marks.count("update") == 2

    # a new held object: every capture goes, one capture anew
    c.swap()
    c.call()
    assert c.program.captures == 2 and len(c.program.entries) == 1
    printed = capsys.readouterr().err
    assert printed.count(f"[{c.name}] graphed (stand-in, capture 1: ") == 1
    assert printed.count(f"[{c.name}] graphed (stand-in, capture 2: ") == 1
    assert printed.count(f"[{c.name}] graphed (stand-in, 1 capture)\n") == 1
    eager = printed.count(f"[{c.name}] eager (per-phase marks)\n")
    assert eager == (0 if c.marks is None else 1)
    assert printed.count(f"[{c.name}] ") == 3 + eager
