"""The benchmark finds each configuration, traffic mix, limit file and
metric by name, BENCHMARK.json keeps to its contract, and a new cell is
new files plus new entries."""

import json
import re
import shutil
import subprocess
import sys


from perfbench.harness import bench as hb

from .conftest import TINY

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
METRIC_KEYS = {"name", "unit", "better", "source", "layer", "moves",
               "workloads", "bound"}


def test_every_cell_finds_its_files():
    spec = hb.benchmark()
    for w in spec["workloads"]:
        cfg = hb.configuration(spec, w["config"])
        assert cfg["flags"]["loadSize"] > 0
        tr = hb.traffic(w["traffic"])
        assert hb.kind(tr["kind"]).run
        assert hb.limits(w["name"])
    for section in ("end_to_end", "per_layer"):
        for m in spec[section]:
            if section == "per_layer":
                assert callable(hb.reader(m["name"]))


def test_benchmark_json_keeps_to_the_contract():
    spec = hb.benchmark()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    assert all(not p.startswith("/") and ".." not in p for p in spec["paths"])
    names = [c["name"] for c in spec["configs"]]
    assert len(set(names)) == len(names)
    for c in spec["configs"]:
        assert set(c) == CONFIG_KEYS and NAME.match(c["name"])
        assert c["file"].startswith("perfbench/")
        assert not c["reduced"]
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == CELL_KEYS and NAME.match(w["name"])
        assert w["config"] in names and w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert 1 <= len(w["why"]) <= 200
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert set(m) <= METRIC_KEYS and NAME.match(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        reporting = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= reporting
    for w in cells:         # every cell: setup_s, another e2e, a layer
        assert sum(w in m.get("workloads", cells)
                   for m in spec["end_to_end"]) >= 2
        assert any(w in m["workloads"] for m in spec["per_layer"])
    assert len(json.dumps(spec)) < 64 * 1024


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    limit file and a metric by adding files and entries only; the copy's
    loaders find all four. The configuration names the other generator
    (netG "local"), which the reference builds and draws weights for."""
    root = tmp_path / "checkout"
    shutil.copytree(hb.BENCH, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = hb.benchmark()
    cfg = json.loads((hb.ROOT / spec["configs"][0]["file"]).read_text())
    cfg["flags"].update(TINY, tex_tile=32, netG="local",
                        n_local_enhancers=1, n_blocks_local=3,
                        niter_fix_global=0)
    (root / "perfbench/configs/dummy.json").write_text(json.dumps(cfg))
    (root / "perfbench/traffic/dummy_mix.json").write_text(json.dumps(
        {"kind": "train", "pool": 4, "first_steps": 3, "trace_from": 1,
         "trace_steps": 1}))
    (root / "perfbench/limits/dummy.dummy_mix.json").write_text(json.dumps(
        {"numbers": {"loss_gap": {"limit": 1.0}}}))
    (root / "perfbench/metrics/dummy_metric.py").write_text(
        "def read(r):\n    return r.get('dummy')\n")
    spec["configs"].append({"name": "dummy", "source": "a test",
                            "file": "perfbench/configs/dummy.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "dummy.dummy_mix", "config": "dummy",
                              "traffic": "dummy_mix", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "dummy_metric", "unit": "s",
                              "better": "lower", "source": "program_span",
                              "layer": "harness", "moves": "setup_s",
                              "workloads": ["dummy.dummy_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    probe = (
        "from perfbench.harness import bench as hb\n"
        "s = hb.benchmark(); w = hb.cell(s, 'dummy.dummy_mix')\n"
        "print(hb.configuration(s, w['config'])['flags']['tex_tile'],\n"
        "      hb.traffic(w['traffic'])['pool'],\n"
        "      hb.limits(w['name'])['loss_gap']['limit'],\n"
        "      hb.reader('dummy_metric')({'dummy': 7}),\n"
        "      [m['name'] for m in hb.metrics_of(s, w['name'], 'per_layer')])\n"
        "from perfbench.harness import data\n"
        "from perfbench.reference import nets\n"
        "from perfbench.reference.config import reference_config\n"
        "cfg = reference_config(hb.configuration(s, w['config'])['flags'])\n"
        "G = nets.build(cfg, 'meta', vgg=False)['G']\n"
        "wts = data.generator_weights(G, 5, 'cpu')\n"
        "print(G.TransG.backbone_name, G.TexG.backbone_name,\n"
        "      sum('enh1_block2' in k for k in wts))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=root,
                         capture_output=True, text=True, check=True).stdout
    assert out.split()[:4] == ["32", "4", "1.0", "7"]
    assert "'dummy_metric'" in out
    assert out.split()[-3:] == ["LocalEnhancer_0", "LocalEnhancer_0", "8"]


def test_a_checkout_of_the_benchmark_alone_refuses_to_run(tmp_path):
    """In a directory with BENCHMARK.json and perfbench/ only, a run exits
    non-zero and prints no result."""
    shutil.copytree(hb.BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(hb.ROOT / "BENCHMARK.json", tmp_path)
    cell = hb.benchmark()["workloads"][0]["name"]
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        cell, "--seed", "5", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""
