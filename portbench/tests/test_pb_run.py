"""A whole run of the harness on the CPU at a tiny size (its look for a
card skipped): the result line's shape, `correct` true for the port as it
is, and false with the timed path broken underneath it, once for each
fault a prove can have, and for the control (the reference at 224-bit
scalars in the port's place)."""
import json

import pytest

from portbench import bench, control
from portbench.tests._tiny import CELLS, layout


def _fault(monkeypatch, fault):
    from ultragroth_tpu_torch.oracle import curve as oc
    from ultragroth_tpu_torch.protocol import prover as P
    if fault == "answer_altered":          # pi_a moved where it is made
        for name in ("finalize_proof", "finalize_ultragroth"):
            orig = getattr(P, name)

            def altered(*a, _orig=orig, **k):
                proof = _orig(*a, **k)
                proof.pi_a = oc.g1_add(proof.pi_a, oc.G1)
                return proof
            monkeypatch.setattr(P, name, altered)
    elif fault == "half_batch_left_out":   # each MSM over half its scalars
        orig = P._msm.msm

        def half(group, table, inf, scalars, c):
            scalars = scalars.clone()
            scalars[:, scalars.shape[1] // 2:] = 0
            return orig(group, table, inf, scalars, c)
        monkeypatch.setattr(P._msm, "msm", half)
    elif fault == "quotient_unchanged":    # the quotient returns its input
        monkeypatch.setattr(P._ResidentKey, "_quotient",
                            lambda self, a, b: P.kernels.fr_mont_mul(
                                a, P.fr().const(1, (1,), a.device, a.dtype)))
    elif fault == "lookup_unchanged":      # the lookup scatter returns w
        monkeypatch.setattr(P.TorchUltraGrothProver, "_lookup_scatter",
                            lambda self, w, lookup, rand: w)


RUNS = [(p, f) for p in ("groth16", "ultragroth")
        for f in (None, "answer_altered", "half_batch_left_out",
                  "quotient_unchanged")] + [("ultragroth", "lookup_unchanged")]


@pytest.mark.parametrize("protocol,fault", RUNS)
def test_run_is_correct_only_when_the_path_is_sound(protocol, fault,
                                                    tmp_path, monkeypatch):
    monkeypatch.setenv("ULTRAGROTH_PLATFORM", "cpu")
    b, base = layout(tmp_path)
    if fault:
        _fault(monkeypatch, fault)
    cell = bench.load_cell(b, CELLS[protocol][0], False, base)
    res = bench.run(cell, 2**31 + 12345, 0.01, False, device="cpu",
                    cache=tmp_path / "cache", log=lambda m: None)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is (fault is None), res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    want = {"proofs_per_s", "setup_s"} | (
        {"prove_p95_ms"} if protocol == "groth16" else set())
    assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert all(set(c) == {"value", "holds", "limit"}
               for c in res["checks"].values())
    json.dumps(res)


@pytest.mark.parametrize("protocol", ["groth16", "ultragroth"])
def test_control_is_not_correct(protocol, tmp_path):
    b, base = layout(tmp_path)
    cell = bench.load_cell(b, CELLS[protocol][0], False, base)
    res = bench.run(cell, 5, 0.01, False, device="cpu",
                    cache=tmp_path / "cache", prover_factory=control.factory,
                    log=lambda m: None)
    assert res["correct"] is False
    assert res["checks"]["proofs_wrong"]["value"] == \
        res["checks"]["proofs_checked"]["value"] >= 1


def test_traced_line_carries_the_trace(tmp_path, monkeypatch):
    """--trace 1 on the control (fast on the CPU): per-layer metrics, the
    device's busy and window seconds, the breakdown."""
    b, base = layout(tmp_path)
    cell = bench.load_cell(b, CELLS["groth16"][0], True, base)
    res = bench.run(cell, 6, 0.01, True, device="cpu",
                    cache=tmp_path / "cache", prover_factory=control.factory,
                    log=lambda m: None)
    assert list(res)[-2:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "key_load_s" in res["metrics"]
    # no device time on the CPU: the device metrics are left out, not 0
    assert "drain_roofline" not in res["metrics"]
    assert "device_idle_share" not in res["metrics"]
