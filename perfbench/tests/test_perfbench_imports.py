"""Nothing the benchmark runs imports JAX, jaxlib, flax or the JAX
package (top-level names compared whole: the port's name begins with the
JAX package's), and the reference imports nothing of the port."""

import ast
import sys
from pathlib import Path

from perfbench import run
from perfbench.harness import bench as hb

JAXY = {"jax", "jaxlib", "flax", "neural_human_video_rendering_tpu"}
PORT = "neural_human_video_rendering_tpu_torch"


def imported_top_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def sources(sub: str = ""):
    return sorted(p for p in (hb.BENCH / sub).rglob("*.py")
                  if "tests" not in p.relative_to(hb.BENCH).parts)


def test_no_source_under_perfbench_imports_jax():
    assert sources()
    for p in sources():
        assert not JAXY & set(imported_top_names(p)), p


def test_the_reference_imports_nothing_of_the_port():
    files = sources("reference")
    assert len(files) >= 5
    for p in files:
        names = set(imported_top_names(p))
        assert PORT not in names and not JAXY & names, p
        assert PORT not in p.read_text(), p


def test_the_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, PORT + "_probe", object())
    assert run.forbidden_modules() == sorted(
        {m.split(".", 1)[0] for m in sys.modules} & JAXY)
    monkeypatch.setitem(sys.modules, "flax.core", object())
    assert "flax" in run.forbidden_modules()
