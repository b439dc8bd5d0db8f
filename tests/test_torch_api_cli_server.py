"""PyTorch port: the entry points (`api`, `cli`, `server`, `trace.ProveAborted`),
the twin of tests/test_api_cli_server.py.

The same sizes, error codes and verifier results as the JAX package's API;
proofs of the `torch` backend on the CPU (`device="cpu"`,
ULTRAGROTH_PLATFORM=cpu) byte-equal to `ultragroth_tpu.api`'s oracle
backend for pinned randomness; the CLI round trips; the server's status
machine, UltraGroth autodetect, preemption by a second request and
/cancel during a prove; the runtime's refusals and its build directory.
"""
import json
import os
import pathlib
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from ultragroth_tpu import api as japi
from ultragroth_tpu_torch import api
from ultragroth_tpu_torch import constants as C
from ultragroth_tpu_torch import runtime
from ultragroth_tpu_torch.constants import FR_MODULUS as R
from ultragroth_tpu_torch.io.binfile import pack_binfile
from ultragroth_tpu_torch.testkit.circuits import (LookupCircuit,
                                                  square_chain_circuit)
from ultragroth_tpu_torch.testkit.setup import groth16_setup, ultragroth_setup

PINS = dict(r=0x1234567, s=0x89ABCDEF)


@pytest.fixture(scope="module")
def small_groth16():
    r1cs, wtns = square_chain_circuit(5, seed=11)
    setup = groth16_setup(r1cs, seed=12)
    sec1 = ((32).to_bytes(4, "little") + R.to_bytes(32, "little")
            + r1cs.n_vars.to_bytes(4, "little"))
    wtns_bytes = pack_binfile(C.WTNS_MAGIC, 2, [(1, sec1), (2, wtns.tobytes())])
    return setup, wtns_bytes


@pytest.fixture(scope="module")
def small_ultra():
    circ = LookupCircuit(chunk_values=[1, 0, 1], table_size=2)
    setup = ultragroth_setup(circ.r1cs, circ.round_indexes,
                             circ.final_indexes, circ.rand_indx, seed=21)
    return circ, setup


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("ULTRAGROTH_PLATFORM", "cpu")


def test_api_sizes_and_errors(small_groth16, small_ultra):
    setup, _ = small_groth16
    circ, usetup = small_ultra
    assert api.groth16_proof_size() == japi.groth16_proof_size() == 810
    assert api.ultra_groth_proof_size() == japi.ultra_groth_proof_size()
    assert api.groth16_public_size_for_zkey_buf(setup.zkey_bytes) == \
        japi.groth16_public_size_for_zkey_buf(setup.zkey_bytes) == 86
    assert api.ultra_groth_public_size_for_zkey_buf(usetup.zkey_bytes) == \
        japi.ultra_groth_public_size_for_zkey_buf(usetup.zkey_bytes)
    for name in ("PROVER_OK", "PROVER_ERROR", "PROVER_ERROR_SHORT_BUFFER",
                 "PROVER_INVALID_WITNESS_LENGTH", "VERIFIER_VALID_PROOF",
                 "VERIFIER_INVALID_PROOF", "VERIFIER_ERROR"):
        assert getattr(api, name) == getattr(japi, name)
    assert api.InvalidWitnessLength.code == japi.InvalidWitnessLength.code
    with pytest.raises(Exception):
        api.groth16_public_size_for_zkey_buf(b"nope")
    with pytest.raises(api.ProverError):
        api.Groth16Prover(setup.zkey_bytes, backend="jax")


def test_api_oneshot_prove_verify(small_groth16, small_ultra):
    setup, wtns_bytes = small_groth16
    proof_json, public_json = api.groth16_prover(
        setup.zkey_bytes, wtns_bytes, backend="oracle")
    vk_json = json.dumps(setup.vk_json)
    assert api.groth16_verify(proof_json, public_json, vk_json) \
        == api.VERIFIER_VALID_PROOF
    bad = json.dumps([str(int(json.loads(public_json)[0]) + 1)])
    assert api.groth16_verify(proof_json, bad, vk_json) \
        == api.VERIFIER_INVALID_PROOF
    assert api.groth16_verify("junk", public_json, vk_json) \
        == api.VERIFIER_ERROR
    circ, usetup = small_ultra
    proof_json, public_json = api.ultra_groth_prover(
        usetup.zkey_bytes, circ.uwtns_bytes(), backend="oracle")
    assert api.ultra_groth_verify(proof_json, public_json,
                                  json.dumps(usetup.vk_json)) \
        == api.VERIFIER_VALID_PROOF
    assert json.loads(public_json) == [str(circ.pub_x)]


def test_api_invalid_witness_length(small_groth16):
    setup, _ = small_groth16
    prover = api.Groth16Prover(setup.zkey_bytes, backend="oracle")
    sec1 = ((32).to_bytes(4, "little") + R.to_bytes(32, "little")
            + (3).to_bytes(4, "little"))
    bad = pack_binfile(C.WTNS_MAGIC, 2, [(1, sec1), (2, b"\0" * (3 * 32))])
    with pytest.raises(api.InvalidWitnessLength):
        prover.prove(bad)


def test_prove_abort_check(small_groth16, on_cpu):
    """Cooperative cancel: an abort_check that fires stops the prove at
    the next phase mark with ProveAborted; a check that never fires leaves
    the prove intact, and its proof (torch backend on the CPU, pinned
    randomness) is byte-equal to the JAX package's oracle backend's."""
    from ultragroth_tpu_torch.trace import ProveAborted
    setup, wtns_bytes = small_groth16
    prover = api.Groth16Prover(setup.zkey_bytes)      # ULTRAGROTH_PLATFORM
    assert prover._prover.device.type == "cpu"
    with pytest.raises(ProveAborted):
        prover.prove(wtns_bytes, abort_check=lambda: True)
    got = prover.prove(wtns_bytes, abort_check=lambda: False, **PINS)
    want = japi.Groth16Prover(setup.zkey_bytes, backend="oracle").prove(
        wtns_bytes, **PINS)
    assert got == want
    assert api.groth16_verify(*got, json.dumps(setup.vk_json)) \
        == api.VERIFIER_VALID_PROOF


def test_api_ultra_torch_matches_jax_oracle(small_ultra):
    """UltraGroth through the torch backend on the CPU, pinned r0, r, s:
    proof and publics byte-equal to the JAX package's oracle backend."""
    circ, setup = small_ultra
    pins = dict(r0=0x5151, **PINS)
    got = api.UltraGrothProver(setup.zkey_bytes, device="cpu").prove(
        circ.uwtns_bytes(), **pins)
    want = japi.UltraGrothProver(setup.zkey_bytes, backend="oracle").prove(
        circ.uwtns_bytes(), **pins)
    assert got == want
    assert api.ultra_groth_verify(*got, json.dumps(setup.vk_json)) \
        == api.VERIFIER_VALID_PROOF


def test_cli_roundtrip(tmp_path):
    """setup -> prove -> verify, and a tampered public input refused, all
    through the port's CLI (the oracle backend, as the JAX package's twin
    test; the torch backend's CLI prove runs on the card in
    chip_smoke.py)."""
    from ultragroth_tpu_torch.cli import main as cli_main
    zkey, vk, wtns = (tmp_path / "c.zkey", tmp_path / "vk.json",
                      tmp_path / "w.wtns")
    assert cli_main(["setup", str(zkey), "--vk", str(vk), "--wtns",
                     str(wtns), "--constraints", "5", "--seed", "4"]) == 0
    proof, public = tmp_path / "p.json", tmp_path / "pub.json"
    assert cli_main(["prove", str(zkey), str(wtns), str(proof),
                     str(public), "--backend", "oracle"]) == 0
    assert cli_main(["verify", str(vk), str(public), str(proof)]) == 0
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([str(int(json.loads(public.read_text())[0])
                                   + 1)]))
    assert cli_main(["verify", str(vk), str(bad), str(proof)]) == 1
    # a witness of the wrong length is refused with exit code 1
    other = tmp_path / "o.wtns"
    assert cli_main(["setup", str(tmp_path / "o.zkey"), "--wtns", str(other),
                     "--constraints", "6"]) == 0
    assert cli_main(["prove", str(zkey), str(other), str(proof), str(public),
                     "--backend", "oracle"]) == 1


def test_cli_setup_ultra_roundtrip(tmp_path):
    """setup-ultra -> prove-ultra -> verify-ultra, the JAX package's CLI
    accepting the port's proof too."""
    from ultragroth_tpu.cli import main as jcli_main
    from ultragroth_tpu_torch.cli import main as cli_main
    zkey, vk, uwtns = (tmp_path / "u.zkey", tmp_path / "u_vk.json",
                       tmp_path / "u.uwtns")
    assert cli_main(["setup-ultra", str(zkey), "--vk", str(vk),
                     "--uwtns", str(uwtns), "--chunks", "6",
                     "--table-size", "4", "--seed", "3"]) == 0
    proof, public = tmp_path / "p.json", tmp_path / "pub.json"
    assert cli_main(["prove-ultra", str(zkey), str(uwtns), str(proof),
                     str(public), "--backend", "oracle"]) == 0
    assert cli_main(["verify-ultra", str(vk), str(public), str(proof)]) == 0
    assert jcli_main(["verify-ultra", str(vk), str(public), str(proof)]) == 0
    bad = tmp_path / "bad.json"
    pub0 = json.loads(public.read_text())
    bad.write_text(json.dumps([str(int(pub0[0]) + 1)] + pub0[1:]))
    assert cli_main(["verify-ultra", str(vk), str(bad), str(proof)]) == 1


def _start(fp_httpd):
    fp, httpd = fp_httpd
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return fp, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _status(base):
    return json.load(urllib.request.urlopen(f"{base}/status"))


def _post(base, path, data=b"", octet=False):
    headers = {"Content-Type": "application/octet-stream"} if octet else {}
    req = urllib.request.Request(f"{base}{path}", data=data, headers=headers)
    return urllib.request.urlopen(req).status


def _wait(base, done, seconds=120):
    for _ in range(int(seconds / 0.05)):
        st = _status(base)
        if done(st["status"]):
            return st
        time.sleep(0.05)
    raise AssertionError(f"status stuck at {st}")


def test_server_status_machine(tmp_path, small_groth16):
    from ultragroth_tpu_torch.server import serve
    setup, wtns_bytes = small_groth16
    zkey = tmp_path / "circ.zkey"
    zkey.write_bytes(setup.zkey_bytes)
    fp, httpd, base = _start(serve([str(zkey)], port=0, backend="oracle"))
    try:
        assert _status(base)["status"] == "ready"
        assert _post(base, "/input/circ", wtns_bytes, octet=True) == 200
        st = _wait(base, lambda s: s not in ("busy", "ready"))
        assert st["status"] == "success", st
        assert api.groth16_verify(st["proof"], st["pubData"],
                                  json.dumps(setup.vk_json)) \
            == api.VERIFIER_VALID_PROOF
        with pytest.raises(urllib.error.HTTPError):
            _post(base, "/input/nope", b"{}")
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/nope")
        for path in ("/cancel", "/start", "/stop", "/config"):
            assert _post(base, path) == 200
        # circuit input JSON without a witness generator: failed, with why
        assert _post(base, "/input/circ", b"{}") == 200
        st = _wait(base, lambda s: s not in ("busy", "ready"))
        assert st["status"] == "failed" and "witness" in st["error"]
    finally:
        httpd.shutdown()


def test_server_ultragroth_autodetect(tmp_path, small_ultra):
    from ultragroth_tpu_torch.server import serve
    circ, setup = small_ultra
    zkey = tmp_path / "ug.zkey"
    zkey.write_bytes(setup.zkey_bytes)
    fp, httpd, base = _start(serve([str(zkey)], port=0, backend="oracle"))
    try:
        assert type(fp.provers["ug"]).__name__ == "UltraGrothProver"
        assert _post(base, "/input/ug", circ.uwtns_bytes(), octet=True) == 200
        st = _wait(base, lambda s: s not in ("busy", "ready"))
        assert st["status"] == "success", st
        assert api.ultra_groth_verify(st["proof"], st["pubData"],
                                      json.dumps(setup.vk_json)) \
            == api.VERIFIER_VALID_PROOF
        assert json.loads(st["pubData"]) == [str(circ.pub_x)]
    finally:
        httpd.shutdown()


def test_server_preempt_and_cancel(tmp_path, small_groth16, on_cpu):
    """torch backend on the CPU: a second request preempts the prove in
    flight (it ends at its next phase mark and the pending request runs:
    here circuit input JSON with no witness generator, which fails at
    once); /cancel during a prove gives `aborted` with no proof."""
    from ultragroth_tpu_torch.server import serve
    setup, wtns_bytes = small_groth16
    zkey = tmp_path / "circ.zkey"
    zkey.write_bytes(setup.zkey_bytes)
    fp, httpd, base = _start(serve([str(zkey)], port=0))
    seen = []
    orig = fp._calc_finished
    fp._calc_finished = lambda *a: (seen.append(fp.canceled), orig(*a))
    try:
        assert _post(base, "/input/circ", wtns_bytes, octet=True) == 200
        _wait(base, lambda s: s == "busy")
        assert _post(base, "/input/circ", b"{}") == 200
        st = _wait(base, lambda s: s not in ("busy", "ready"))
        assert st["status"] == "failed", st
        assert seen == [True, False]          # the first was preempted
        assert _post(base, "/input/circ", wtns_bytes, octet=True) == 200
        _wait(base, lambda s: s == "busy")
        assert _post(base, "/cancel") == 200
        st = _wait(base, lambda s: s != "busy")
        assert st["status"] == "aborted", st
        assert fp.proof is None               # stopped at a mark, no proof
    finally:
        httpd.shutdown()


def test_runtime_platform_and_refusals(monkeypatch, tmp_path):
    monkeypatch.setenv("ULTRAGROTH_PLATFORM", "cpu")
    assert str(runtime.default_device()) == "cpu"
    monkeypatch.setenv("ULTRAGROTH_PLATFORM", "tpu")
    with pytest.raises(ValueError):
        runtime.default_device()
    monkeypatch.delenv("ULTRAGROTH_PLATFORM")
    import torch
    if not torch.cuda.is_available():       # no silent fall back to the CPU
        with pytest.raises(RuntimeError):
            runtime.default_device()
    monkeypatch.setenv("ULTRAGROTH_COMPILE_CACHE", str(tmp_path))
    assert runtime.compile_cache_dir() == tmp_path
    monkeypatch.delenv("ULTRAGROTH_COMPILE_CACHE")
    assert runtime.compile_cache_dir() == runtime.DEFAULT_CACHE
    # ULTRAGROTH_COORDINATOR: configure() forms the multi-process runtime
    # (parallel.mesh.distributed_init; a real two-process run is
    # tests/test_torch_distributed.py)
    from ultragroth_tpu_torch.parallel import mesh as pmesh
    calls = []
    monkeypatch.setattr(pmesh, "distributed_init",
                        lambda: calls.append(os.environ.get(
                            "ULTRAGROTH_COORDINATOR")) or True)
    monkeypatch.setattr(runtime, "_CONFIGURED", False)
    monkeypatch.setenv("ULTRAGROTH_COORDINATOR", "localhost:1234")
    runtime.configure()
    assert calls == ["localhost:1234"]
    monkeypatch.delenv("ULTRAGROTH_COORDINATOR")
    runtime.configure()
    assert len(calls) == 1               # once a process


def test_compile_cache_off_builds_in_a_removed_temporary_directory(tmp_path):
    """ULTRAGROTH_COMPILE_CACHE=off means no persistent cache, as in the JAX
    package (ultragroth_tpu/runtime.py): the kernel libraries go to a
    temporary directory of the process, removed when it exits, and never
    to a directory named `off` under the working directory."""
    repo = pathlib.Path(__file__).resolve().parent.parent
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    code = ("from ultragroth_tpu_torch import runtime\n"
            "from ultragroth_tpu_torch.ops import _build\n"
            "d = runtime.compile_cache_dir()\n"
            "assert d == runtime.compile_cache_dir() and d.is_dir()\n"
            "assert _build.library_path('g1_kernels.cu').parent == d\n"
            "(d / 'lib.so').write_bytes(b'')\n"
            "print(d)\n")
    env = dict(os.environ, ULTRAGROTH_COMPILE_CACHE="off", TMPDIR=str(tmp),
               PYTHONPATH=str(repo))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    built = pathlib.Path(out.stdout.strip())
    assert built.parent == tmp and built.name.startswith("ultragroth_")
    assert not built.exists()                  # removed at exit
    assert not (tmp_path / "off").exists()


def test_tracer_trace_profile_and_abort(monkeypatch, tmp_path, capsys):
    """ULTRAGROTH_TRACE prints one line per phase; ULTRAGROTH_PROFILE writes
    a torch.profiler Chrome trace per session with each phase a named
    range; an abort_check is polled at every mark."""
    from ultragroth_tpu_torch import trace
    monkeypatch.setenv("ULTRAGROTH_TRACE", "1")
    monkeypatch.setenv("ULTRAGROTH_PROFILE", str(tmp_path))
    polls = []
    with trace.profile_session("unit-prove"):
        t = trace.Tracer("cpu", "unit-prove",
                         abort_check=lambda: polls.append(1) or False)
        assert t.run("msm_a", lambda: sum(range(1000))) == 499500
        t.mark("finalize")
        ms = t.report()
    assert list(ms) == ["msm_a", "finalize"] and len(polls) == 2
    err = capsys.readouterr().err
    assert "unit-prove msm_a:" in err and "unit-prove total:" in err
    profile = json.loads((tmp_path / "unit-prove.json").read_text())
    names = {e.get("name") for e in profile["traceEvents"]}
    assert "unit-prove:msm_a" in names
    monkeypatch.delenv("ULTRAGROTH_TRACE")
    t = trace.Tracer("cpu", abort_check=lambda: True)
    with pytest.raises(trace.ProveAborted, match="upload"):
        t.run("upload", lambda: None)
