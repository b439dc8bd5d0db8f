"""PyTorch port: the C ABI (`capi.py` + `csrc/capi_shim.cpp`, built by
`capi.build_libraries()` with g++) driven in-process through ctypes, and
the unchanged remote client (`native/ultragroth_remote.c`) against the
port's proof server: the twins of tests/test_capi_native.py and
tests/test_remote_client.py, on a testkit circuit.

The shim embeds CPython; loaded into this running interpreter,
PyGILState_Ensure attaches to it, so the test calls the extern-C symbols
as an FFI consumer would and watches the Python side (a zkey parse
counter) for the create-once / prove-many contract.  The libraries are
built here, so nothing is skipped for want of a prebuilt one.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import socket
import subprocess
import threading
import time

import pytest
import torch

from ultragroth_tpu_torch import capi
from ultragroth_tpu_torch import constants as C
from ultragroth_tpu_torch.constants import FR_MODULUS as R
from ultragroth_tpu_torch.io.binfile import pack_binfile
from ultragroth_tpu_torch.testkit.circuits import square_chain_circuit
from ultragroth_tpu_torch.testkit.setup import groth16_setup

api = capi.api
ULL = ctypes.c_ulonglong


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain kernel versions run many small tensor ops: one intra-op
    thread runs them faster here and leaves the other test workers'
    cores alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def libs():
    return capi.build_libraries()


@pytest.fixture(scope="module")
def lib(libs):
    return ctypes.CDLL(str(libs["capi"]))


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("ULTRAGROTH_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    td = tmp_path_factory.mktemp("capi")
    r1cs, wtns = square_chain_circuit(5, seed=31)
    setup = groth16_setup(r1cs, seed=32)
    zkey = td / "c.zkey"
    zkey.write_bytes(setup.zkey_bytes)
    sec1 = ((32).to_bytes(4, "little") + R.to_bytes(32, "little")
            + r1cs.n_vars.to_bytes(4, "little"))
    wtns_bytes = pack_binfile(C.WTNS_MAGIC, 2,
                              [(1, sec1), (2, wtns.tobytes())])
    return zkey, wtns_bytes, setup.vk_json


def _prove(fn, handle, wtns_bytes, proof_cap=4096, public_cap=4096):
    proof = ctypes.create_string_buffer(proof_cap)
    public = ctypes.create_string_buffer(public_cap)
    err = ctypes.create_string_buffer(512)
    psz, usz = ULL(proof_cap), ULL(public_cap)
    rc = fn(handle, wtns_bytes, ULL(len(wtns_bytes)), proof,
            ctypes.byref(psz), public, ctypes.byref(usz), err, ULL(512))
    return rc, proof.value.decode(), public.value.decode(), psz, usz, err


def test_handle_create_prove_twice_destroy(lib, fixture_files, monkeypatch):
    """create from a file, two proves (the first into a short buffer: the
    required sizes come back; the retry with them succeeds), destroy; the
    zkey is parsed once."""
    zkey_path, wtns_bytes, vk_json = fixture_files
    calls = {"n": 0}
    real_parse = api.parse_groth16_zkey

    def counting_parse(buf):
        calls["n"] += 1
        return real_parse(buf)

    monkeypatch.setattr(api, "parse_groth16_zkey", counting_parse)
    obj = ctypes.c_void_p()
    err = ctypes.create_string_buffer(512)
    rc = lib.groth16_prover_create_zkey_file(
        ctypes.byref(obj), str(zkey_path).encode(), err, ULL(512))
    assert rc == 0, err.value
    assert obj.value and calls["n"] == 1

    rc, _, _, psz, usz, _ = _prove(lib.groth16_prover_prove, obj,
                                   wtns_bytes, proof_cap=8)
    assert rc == api.PROVER_ERROR_SHORT_BUFFER
    assert psz.value > 8 and usz.value > 0     # required sizes written back
    # the retry proves with fresh randomness, whose decimal coordinates may
    # be longer: the proof buffer takes the protocol's size query too
    proof_size = ULL(0)
    lib.groth16_proof_size.restype = None
    lib.groth16_proof_size(ctypes.byref(proof_size))
    assert psz.value <= proof_size.value
    rc, proof, public, _, _, err2 = _prove(
        lib.groth16_prover_prove, obj, wtns_bytes,
        proof_cap=proof_size.value, public_cap=usz.value)
    assert rc == 0, err2.value
    assert proof.startswith("{")
    assert api.groth16_verify(proof, public, json.dumps(vk_json)) \
        == api.VERIFIER_VALID_PROOF
    assert calls["n"] == 1      # create-once / prove-many
    lib.groth16_prover_destroy(obj)


def test_oneshot_zkey_file_sizes_and_verify(lib, fixture_files):
    zkey_path, wtns_bytes, vk_json = fixture_files
    proof = ctypes.create_string_buffer(4096)
    public = ctypes.create_string_buffer(4096)
    err = ctypes.create_string_buffer(512)
    psz, usz = ULL(4096), ULL(4096)
    rc = lib.groth16_prover_zkey_file(
        str(zkey_path).encode(), wtns_bytes, ULL(len(wtns_bytes)), proof,
        ctypes.byref(psz), public, ctypes.byref(usz), err, ULL(512))
    assert rc == 0, err.value
    vk = json.dumps(vk_json).encode()
    # the verifier ABI: valid, then a tampered public input
    assert lib.groth16_verify(proof.value, public.value, vk, err,
                              ctypes.c_ulong(512)) == api.VERIFIER_VALID_PROOF
    pub = json.loads(public.value)
    bad = json.dumps([str(int(pub[0]) + 1)] + pub[1:]).encode()
    assert lib.groth16_verify(proof.value, bad, vk, err, ctypes.c_ulong(
        512)) == api.VERIFIER_INVALID_PROOF

    sz = ULL(0)
    lib.groth16_proof_size.restype = None
    lib.groth16_proof_size(ctypes.byref(sz))
    assert sz.value == C.PROOF_BUFFER_MIN_SIZE
    psz2 = ULL(0)
    rc = lib.groth16_public_size_for_zkey_file(
        str(zkey_path).encode(), ctypes.byref(psz2), err, ULL(512))
    assert rc == 0 and psz2.value == api.groth16_public_size_for_zkey_file(
        zkey_path)
    zk = zkey_path.read_bytes()
    psz3 = ULL(0)
    rc = lib.groth16_public_size_for_zkey_buf(zk, ULL(len(zk)),
                                              ctypes.byref(psz3), err,
                                              ULL(512))
    assert rc == 0 and psz3.value == psz2.value

    # error path: a missing file -> PROVER_ERROR with a message
    obj = ctypes.c_void_p()
    rc = lib.groth16_prover_create_zkey_file(
        ctypes.byref(obj), b"/nonexistent/x.zkey", err, ULL(512))
    assert rc == api.PROVER_ERROR and err.value


def test_public_headers_compile_and_link(libs, tmp_path):
    """native/include/ultragroth/*.h compile standalone and link against
    the port's shim as a packaged consumer would."""
    cc = shutil.which("cc") or shutil.which("g++")
    libdir = libs["capi"].parent
    src = tmp_path / "consumer.c"
    src.write_text(
        '#include "ultragroth/prover.h"\n'
        '#include "ultragroth/verifier.h"\n'
        "int main(void) {\n"
        "    unsigned long long n = 0, m = 0;\n"
        "    groth16_proof_size(&n);\n"
        "    ultra_groth_proof_size(&m);\n"
        "    return (n == 810 && m == 1400) ? 0 : 1;\n"
        "}\n")
    exe = tmp_path / "consumer"
    subprocess.run(
        [cc, str(src), f"-I{capi.INCLUDE_DIR}", f"-L{libdir}",
         "-lultragroth", f"-Wl,-rpath,{libdir}", "-o", str(exe)],
        check=True, capture_output=True)
    assert subprocess.run([str(exe)], capture_output=True,
                          timeout=60).returncode == 0


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_remote_client_against_port_server(libs, fixture_files,
                                           monkeypatch):
    """The remote client's prover ABI against `ultragroth_tpu_torch.server`
    (the oracle backend, as in the JAX package's test): create by the
    zkey's stem, the short-buffer retry, a proof that verifies; an unknown
    circuit surfaces the server's error."""
    from ultragroth_tpu_torch.server import serve
    zkey_path, wtns_bytes, vk_json = fixture_files
    port = _free_port()
    _, httpd = serve([str(zkey_path)], port, backend="oracle")
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        t0 = time.time()
        while time.time() - t0 < 10:
            try:
                socket.create_connection(("127.0.0.1", port), 1).close()
                break
            except OSError:
                time.sleep(0.05)
        monkeypatch.setenv("ULTRAGROTH_SERVER", f"127.0.0.1:{port}")
        lib = ctypes.CDLL(str(libs["remote"]))
        err = ctypes.create_string_buffer(256)
        obj = ctypes.c_void_p()
        rc = lib.groth16_prover_create_zkey_file(
            ctypes.byref(obj), str(zkey_path).encode(), err, ULL(256))
        assert rc == 0, err.value
        rc, _, _, psz, _, err2 = _prove(lib.groth16_prover_prove, obj,
                                        wtns_bytes, proof_cap=8,
                                        public_cap=8)
        assert rc == api.PROVER_ERROR_SHORT_BUFFER, (rc, err2.value)
        assert psz.value > 8
        rc, proof, public, _, _, err2 = _prove(
            lib.groth16_prover_prove, obj, wtns_bytes,
            proof_cap=int(psz.value) + 4096)
        assert rc == 0, err2.value
        lib.groth16_prover_destroy(obj)
        assert api.groth16_verify(proof, public, json.dumps(vk_json)) \
            == api.VERIFIER_VALID_PROOF

        rc = lib.groth16_prover_create_zkey_file(
            ctypes.byref(obj), b"/nope/unknown.zkey", err, ULL(256))
        assert rc == 0, err.value
        rc = _prove(lib.groth16_prover_prove, obj, b"xx")[0]
        assert rc == api.PROVER_ERROR
        lib.groth16_prover_destroy(obj)
    finally:
        httpd.shutdown()
        httpd.server_close()
