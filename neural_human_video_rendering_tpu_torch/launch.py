"""Run a reference launcher script through the port:

    ROOT=/data CKPTS=./checkpoints \\
    python -m neural_human_video_rendering_tpu_torch.launch \\
        launchers/train_e2e.sh mydance [-- <extra port flags>]

reads the script's ``python3 <entry>.py <flags>`` command, expands its
shell variables (``$1``.., ``${VAR}``, ``${VAR:-default}``,
``${VAR:?message}``) from the positional arguments and the environment,
and calls the port's entry point of the same name with the script's flags
and then the extra ones (a later flag wins, so ``--gpu_ids -1`` or an
epoch cap appended after ``--`` overrides the script's):

    pre_train.py      -> pre_train          (stage-1 UV pretrain)
    pre_train_tex.py  -> pre_train_tex      (texture pretrain)
    train.py          -> train              (stage 2)
    test.py           -> infer.test_driver  (inference)
    graph_posenorm.py -> graph_posenorm     (pose retargeting)
    unfold_texture.py -> unfold_texture     (the texture atlas)

Under torchrun each process runs the script as one data-parallel rank
(``runtime.py``), the script unchanged:

    torchrun --nproc_per_node 4 -m neural_human_video_rendering_tpu_torch.launch \
        launchers/train_e2e.sh mydance
"""

from __future__ import annotations

import importlib
import os
import re
import shlex
import sys
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

ENTRY_POINTS = {
    "pre_train.py": "pre_train",
    "pre_train_tex.py": "pre_train_tex",
    "train.py": "train.__main__",
    "test.py": "infer.test_driver",
    "graph_posenorm.py": "graph_posenorm",
    "unfold_texture.py": "unfold_texture",
}

_VAR = re.compile(r"\$\{(\w+)(?::([-?])([^}]*))?\}|\$(\d+)")
_ASSIGN = re.compile(r"^(\w+)=(.*)$")


def _expand(text: str, scope: Mapping[str, str], where: str) -> str:
    def sub(m):
        name = m.group(1) or m.group(4)
        val = scope.get(name, "")
        if m.group(2) == "-" and not val:
            return _expand(m.group(3), scope, where)
        if m.group(2) == "?" and not val:
            raise ValueError(f"{where}: {name} is not set "
                             f"({m.group(3) or 'required'})")
        return val
    return _VAR.sub(sub, text)


def launcher_argv(script: str, args: Sequence[str] = (),
                  env: Optional[Mapping[str, str]] = None
                  ) -> Tuple[str, List[str]]:
    """(the port's entry module, its argv) for a launcher script run with
    positional ``args`` and environment ``env`` (default os.environ)."""
    with open(script) as f:
        lines = f.read().replace("\\\n", " ").splitlines()
    scope: Dict[str, str] = dict(os.environ if env is None else env)
    scope.update({str(i + 1): a for i, a in enumerate(args)})
    for line in lines:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _ASSIGN.match(line)
        if m:
            scope[m.group(1)] = _expand(m.group(2), scope, script)
            continue
        words = shlex.split(_expand(line, scope, script))
        if words[0] in ("python", "python3") and len(words) > 1:
            entry = os.path.basename(words[1])
            if entry not in ENTRY_POINTS:
                raise ValueError(f"{script}: the port has no entry point "
                                 f"for {entry}")
            return ENTRY_POINTS[entry], words[2:]
    raise ValueError(f"{script}: no python command found")


def run_launcher(script: str, args: Sequence[str] = (),
                 extra: Sequence[str] = (),
                 env: Optional[Mapping[str, str]] = None) -> int:
    """Run the launcher's command through the port's entry point's main,
    with ``extra`` flags after the script's."""
    entry, argv = launcher_argv(script, args, env)
    module = importlib.import_module(f"{__package__}.{entry}")
    return module.main(argv + list(extra)) or 0


def main(argv=None) -> int:
    """launch.py SCRIPT [script args] [-- extra port flags]"""
    argv = list(sys.argv[1:] if argv is None else argv)
    extra: List[str] = []
    if "--" in argv:
        cut = argv.index("--")
        argv, extra = argv[:cut], argv[cut + 1:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    return run_launcher(argv[0], argv[1:], extra)


if __name__ == "__main__":
    sys.exit(main())
