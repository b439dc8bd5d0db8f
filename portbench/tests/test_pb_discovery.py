"""The harness finds configurations, traffic mixes and metric readers by
the names BENCHMARK.json gives them, in files of their own."""
import json

import pytest

from portbench import bench, circuits, loops, traffic
from portbench.tests._tiny import layout


def _bench_json():
    return json.loads((bench.HERE.parent / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("trace_on", [False, True])
def test_every_cell_of_the_benchmark_resolves(trace_on):
    b = _bench_json()
    for w in b["workloads"]:
        cell = bench.load_cell(b, w["name"], trace_on)
        circuits.kind(cell.config["circuit"]).build  # the kind exists
        assert cell.metrics, w["name"]
        for m in cell.metrics:
            assert callable(bench.reader(m["name"]).read), m["name"]
        want = {m["name"] for m in (b["per_layer"] if trace_on
                                    else b["end_to_end"])
                if w["name"] in m.get("workloads", [w["name"]])}
        assert {m["name"] for m in cell.metrics} == want


def test_new_config_mix_loop_and_metric_are_found_by_name(tmp_path):
    b, base = layout(tmp_path)
    (base / "traffic" / "another_mix.json").write_text(json.dumps(
        {"loop": "two_at_once", "pool": 3, "warmup": 1, "check": 2}))
    (base / "loops" / "two_at_once.py").write_text(
        "def drive(prover, pool, blind, seconds, mix):\n"
        "    return ('driven', len(pool), seconds, mix['pool'])\n")
    (base / "metrics" / "answer_count.py").write_text(
        "def read(ctx):\n    return len(ctx['window'].outputs)\n")
    b["workloads"].append({"name": "new_cell", "config": "ug_tiny",
                           "traffic": "another_mix", "chips": 1,
                           "why": "added"})
    b["per_layer"].append({"name": "answer_count", "unit": "proofs",
                           "better": "higher", "source": "host_clock",
                           "layer": "provers and API",
                           "moves": "proofs_per_s",
                           "workloads": ["new_cell"]})
    cell = bench.load_cell(b, "new_cell", True, base)
    assert cell.mix["pool"] == 3 and cell.config["circuit"] == "lookup"
    assert cell.loop.drive(None, [1, 2, 3], None, 2.0, cell.mix) == \
        ("driven", 3, 2.0, 3)
    assert [m["name"] for m in cell.metrics] == ["answer_count"]
    win = loops.Window(outputs=[("p", "q")] * 5)
    assert bench.reader("answer_count", base).read({"window": win}) == 5


def test_unknown_names_are_refused(tmp_path):
    b, base = layout(tmp_path)
    with pytest.raises(SystemExit):
        bench.load_cell(b, "no_such_cell", False, base)
    with pytest.raises(ValueError):
        circuits.kind("../etc")
    with pytest.raises(ValueError):
        loops.find("open", base)
    with pytest.raises(ValueError):
        loops.find("../closed", base)
    with pytest.raises(ValueError):
        traffic.validate({"pool": 1, "warmup": 0, "check": 1})
