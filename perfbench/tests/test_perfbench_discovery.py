"""A configuration, a traffic mix, a mode, a feed and a metric added as
files are found by name, with no existing file edited; a fed multi-hot
mix needs no new code; every name and unit in BENCHMARK.json keeps to
the allowed characters, and every file a cell needs is there."""
import json
import re
import shutil
from pathlib import Path

from perfbench.lib import harness
from perfbench.tests import tiny

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_names_and_units():
    b = _bench()
    names = [c["name"] for c in b["configs"]] \
        + [w["name"] for w in b["workloads"]] \
        + [m["name"] for m in b["end_to_end"] + b["per_layer"]] \
        + [w["traffic"] for w in b["workloads"]] \
        + [k for c in b["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert len({m["name"] for m in b["end_to_end"] + b["per_layer"]}) \
        == len(b["end_to_end"]) + len(b["per_layer"])


def test_every_cell_finds_its_files():
    b = _bench()
    for w in b["workloads"]:
        c = harness.Cell(w["name"])
        assert c.per_layer and c.end_to_end
        for m in c.per_layer:
            assert callable(c.reader(m["name"]).read)
        assert set(c.limits) and all(isinstance(v, (int, float))
                                     for v in c.limits.values())


def test_added_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(PB, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench()
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "dlrm-criteo.json").read_text())
    cfg.update(name="dlrm-small", rows=2048, n_sparse=4, embed_dim=8,
               bottom_mlp=[16, 8], top_mlp=[16, 1], param_dtype="float32")
    (pb / "configs" / "dlrm-small.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "train-resident.json").read_text())
    mix.update(batch=128, n_batches=3, zipf_s=0.9, mode="train-tagged",
               feed="reversed")
    (pb / "traffic" / "train-skew09.json").write_text(json.dumps(mix))
    (pb / "modes" / "train-tagged.py").write_text(
        "def run(cell, *args):\n"
        "    line = cell.part('modes', 'train').run(cell, *args)\n"
        "    line['tag'] = 'train-tagged'\n"
        "    return line\n")
    (pb / "feeds" / "reversed.py").write_text(
        "def make(cfg, mix, seed, device):\n"
        "    from perfbench.lib import traffic\n"
        "    feed = __import__('perfbench.feeds.resident', fromlist=['x'])\n"
        "    return feed.ResidentFeed(\n"
        "        traffic.make(cfg, mix, seed, device)[::-1])\n")
    (pb / "limits" / "dlrm-small.train-skew09.json").write_text(
        json.dumps({"loss_gap": 1e-3, "grad_gap": 1e-3, "delta_gap": 1e-3}))
    (pb / "metrics" / "steps_seen.py").write_text(
        "def read(ctx):\n    return float(ctx.steps_seen)\n")
    b["configs"].append({"name": "dlrm-small", "source": "a test",
                         "file": "perfbench/configs/dlrm-small.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "dlrm-small.train-skew09",
                           "config": "dlrm-small", "traffic": "train-skew09",
                           "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "steps_seen", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "train and score step",
                           "moves": "samples_per_s",
                           "workloads": ["dlrm-small.train-skew09"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    before = {p: p.read_bytes() for p in PB.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    c = harness.Cell("dlrm-small.train-skew09", root=root)
    assert c.cfg["rows"] == 2048 and c.mix["zipf_s"] == 0.9
    assert [m["name"] for m in c.per_layer] == ["steps_seen"]
    assert c.reader("steps_seen").read(harness.Ctx(steps_seen=3)) == 3.0
    line = harness.run(c, 99, 0.3, False, "cpu")
    assert line["correct"], line["checks"]
    assert line["tag"] == "train-tagged"
    assert set(line["metrics"]) == {"samples_per_s", "step_ms_p90",
                                    "setup_s"}
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_a_fed_multi_hot_mix_needs_no_new_code():
    """wide-deep through the process pipeline, raw lists of up to 6
    values pooled to its bags of 4: data only."""
    c = tiny.cell("wide-deep.train-resident", batch=256)
    fed = tiny.cell("dlrm-criteo.train-fed").mix
    c.mix.update({k: fed[k] for k in ("feed", "workers", "pin_cpus",
                                      "device_depth")}, pin_cpus=2, k_raw=6)
    c.limits.update(feat_mismatch=0, dense_gap=1e-5)
    line = harness.run(c, 2**32 + 11, 0.3, False, "cpu")
    assert line["correct"], line["checks"]
    assert line["checks"]["feat_mismatch"]["value"] == 0
