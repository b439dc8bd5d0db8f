"""HTTP proof server of the port: the twin of the JAX package's
`server.py` (route and status parity with the reference proverServer,
src/main_proofserver.cpp:36-40 and src/fullprover.{hpp,cpp}):

  GET  /status           -> {"status": ...} (+proof/pubData on success,
                            +error on failure)
  POST /start, /stop     -> 200 (no-ops)
  POST /input/:circuit   -> start a prove; a new request preempts a busy
                            prover (the single pending slot + abort)
  POST /cancel           -> abort the prove in flight, at its next phase
                            mark (`abort_check`, `trace.ProveAborted`)
  GET/POST /config       -> 200 (no-ops)

Status machine: ready | busy | success | failed | aborted.

A circuit's witness is POSTed as a .wtns / .uwtns (Content-Type
application/octet-stream), or as circuit input JSON run through the
witness generator command template `--witgen`.  Proves run on a worker
thread, on the CUDA device that was current when the server was made;
`--devices N` shards each prove over N devices (`api`'s `devices=`).

    python -m ultragroth_tpu_torch.server --port 9080 circuit.zkey ...
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from .api import Groth16Prover, ProverError, UltraGrothProver
from .log import get_logger

LOG = get_logger("ultragroth.server")


class FullProver:
    """Preloads one prover per zkey; runs one prove at a time on a worker
    thread with a single pending slot (latest request wins)."""

    def __init__(self, zkey_paths, witgen: str | None = None,
                 backend: str = "torch", devices=None):
        self.provers = {}
        for path in zkey_paths:
            path = pathlib.Path(path)
            name = path.stem.removesuffix(".zkey")
            try:
                self.provers[name] = UltraGrothProver.from_file(
                    path, backend, devices=devices)
            except Exception:
                self.provers[name] = Groth16Prover.from_file(
                    path, backend, devices=devices)
            LOG.info("circuit loaded: %s (%s)", name,
                     type(self.provers[name]).__name__)
        self.witgen = witgen
        self.status = "ready"
        self.proof = None
        self.pub_data = None
        self.err_string = ""
        self.canceled = False
        self.pending = None        # (circuit, body, is_wtns)
        self.executing = None
        self.mtx = threading.Lock()
        # the worker thread proves on the device current here
        self.cuda_device = (torch.cuda.current_device()
                            if torch.cuda.is_available() else None)

    def start_prove(self, body: bytes, circuit: str, is_wtns: bool):
        with self.mtx:
            if circuit not in self.provers:
                raise KeyError(circuit)
            self.pending = (circuit, body, is_wtns)
            if self.status == "busy":
                self.canceled = True
            self._check_pending()

    def _check_pending(self):
        # caller holds self.mtx
        if self.status != "busy" and self.pending is not None:
            self.executing = self.pending
            self.pending = None
            self.status = "busy"
            LOG.debug("prove started: circuit=%s", self.executing[0])
            self.err_string = ""
            self.canceled = False
            self.proof = None
            threading.Thread(target=self._thread_calculate_prove,
                             daemon=True).start()

    def _witness_bytes(self, circuit: str, body: bytes, is_wtns: bool) -> bytes:
        if is_wtns:
            return body
        if self.witgen is None:
            raise ProverError(
                "no witness generator configured; POST the .wtns directly "
                "with Content-Type: application/octet-stream")
        with tempfile.TemporaryDirectory() as td:
            inp = pathlib.Path(td) / f"input_{circuit}.json"
            out = pathlib.Path(td) / f"{circuit}.wtns"
            inp.write_bytes(body)
            cmd = self.witgen.format(circuit=circuit, input=inp, output=out)
            res = subprocess.run(cmd, shell=True, capture_output=True)
            if res.returncode != 0 or not out.exists():
                raise ProverError(
                    f"witness generator failed: {res.stderr.decode()[:500]}")
            return out.read_bytes()

    def _is_canceled(self) -> bool:
        with self.mtx:
            return self.canceled

    def _thread_calculate_prove(self):
        # All shared state is read/written under self.mtx; the prove itself
        # runs unlocked on local variables so /status and /input stay
        # responsive.  abort_check makes /cancel phase-granular (polled
        # between the prover's MSM/NTT phases) — beyond the reference,
        # which only consults its flag before the prove starts
        # (fullprover.cpp:137-202).
        from .trace import ProveAborted
        if self.cuda_device is not None:
            torch.cuda.set_device(self.cuda_device)
        with self.mtx:
            circuit, body, is_wtns = self.executing
        proof = pub_data = None
        err = ""
        try:
            wtns = self._witness_bytes(circuit, body, is_wtns)
            if not self._is_canceled():
                proof_json, public_json = self.provers[circuit].prove(
                    wtns, abort_check=self._is_canceled)
                proof = json.loads(proof_json)
                pub_data = json.loads(public_json)
        except ProveAborted:
            pass                   # canceled is set; status -> aborted
        except Exception as e:  # noqa: BLE001 - status machine captures all
            err = str(e)
        self._calc_finished(proof, pub_data, err)

    def _calc_finished(self, proof, pub_data, err: str):
        with self.mtx:
            self.proof = proof
            self.pub_data = pub_data
            self.err_string = err
            if self.canceled:
                self.status = "aborted"
            elif err:
                self.status = "failed"
            else:
                self.status = "success"
            if err:
                LOG.error("prove failed: %s", err)
            else:
                LOG.info("prove finished: status=%s", self.status)
            self.canceled = False
            self.executing = None
            self._check_pending()

    def abort(self):
        with self.mtx:
            if self.status == "busy":
                self.canceled = True
                LOG.info("prove abort requested")

    def get_status(self) -> dict:
        with self.mtx:
            st = {"status": self.status}
            if self.status == "failed":
                st["error"] = self.err_string
            elif self.status == "success":
                st["proof"] = json.dumps(self.proof)
                st["pubData"] = json.dumps(self.pub_data)
        return st


class _Handler(BaseHTTPRequestHandler):
    full_prover: FullProver = None  # set by serve()

    def _send(self, code: int, body: bytes = b"",
              ctype: str = "application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/status":
            self._send(200, json.dumps(
                self.full_prover.get_status()).encode())
        elif self.path == "/config":
            self._send(200)
        else:
            self._send(404)

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n) if n else b""
        if self.path.startswith("/input/"):
            circuit = self.path[len("/input/"):]
            is_wtns = self.headers.get(
                "Content-Type", "") == "application/octet-stream"
            try:
                self.full_prover.start_prove(body, circuit, is_wtns)
            except KeyError:
                self._send(404, b'{"error": "unknown circuit"}')
                return
            self._send(200)
        elif self.path == "/cancel":
            self.full_prover.abort()
            self._send(200)
        elif self.path in ("/start", "/stop", "/config"):
            self._send(200)
        else:
            self._send(404)

    def log_message(self, fmt, *args):  # route access log at debug level
        LOG.debug("http: %s", fmt % args)


def serve(zkey_paths, port: int = 9080, witgen: str | None = None,
          backend: str = "torch", devices=None):
    fp = FullProver(zkey_paths, witgen=witgen, backend=backend,
                    devices=devices)
    handler = type("Handler", (_Handler,), {"full_prover": fp})
    httpd = ThreadingHTTPServer(("0.0.0.0", port), handler)
    return fp, httpd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ultragroth_tpu_torch.server",
        description="proof server (route parity with the reference "
                    "proverServer)")
    ap.add_argument("zkeys", nargs="+")
    ap.add_argument("--port", type=int, default=9080)
    ap.add_argument("--witgen", default=None,
                    help="witness generator command template, e.g. "
                         "'./build/{circuit} {input} {output}'")
    ap.add_argument("--backend", default="torch", choices=["torch", "oracle"])
    ap.add_argument("--devices", default=None,
                    help="shard proves over N devices ('all' = every visible "
                         "device); default single-device")
    args = ap.parse_args(argv)
    devices = None if args.devices in (None, "1") else args.devices
    _, httpd = serve(args.zkeys, args.port, args.witgen, args.backend,
                     devices=devices)
    print(f"proof server listening on :{args.port}", file=sys.stderr)
    httpd.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
