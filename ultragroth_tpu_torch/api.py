"""Stable prover / verifier API of the port: the twin of the JAX package's
`api.py`, the Python side of the reference's C surface (src/prover.h,
src/verifier.h of rapidsnark): the same groth16_* / ultra_groth_* entry
points, error codes, size queries and validation order (zkey protocol ->
prime -> witness length).

Backends: `torch` (the default: `TorchGroth16Prover` / `TorchUltraGrothProver`
on the device `runtime.default_device()` picks, the card unless
ULTRAGROTH_PLATFORM=cpu, or the `device=` argument) and `oracle` (the pure
Python provers).  `device=` picks the platform the `torch` backend proves
on; `devices=` shards the prove over a 1-D mesh of that many of the
platform's devices (`parallel.make_mesh`: a power of two, or "all"; None,
the default, proves on one device).  The C ABI over these functions is
`capi.py` and its native shim (`csrc/capi_shim.cpp`).
"""
from __future__ import annotations

import json

import numpy as np

from .runtime import configure as _configure_runtime

_configure_runtime()

from . import constants as C
from .constants import FR_MODULUS
from .io.binfile import BinFileError  # noqa: F401  (part of the API)
from .io.fieldenc import array_to_ints
from .io.wtns import parse_wtns
from .io.zkey import ZKeyError, parse_groth16_zkey, parse_ultragroth_zkey  # noqa: F401
from .protocol import groth16 as g16
from .protocol import ultragroth as ug

# Error codes: src/prover.h:9-12
PROVER_OK = 0x0
PROVER_ERROR = 0x1
PROVER_ERROR_SHORT_BUFFER = 0x2
PROVER_INVALID_WITNESS_LENGTH = 0x3

# src/verifier.h:9-11
VERIFIER_VALID_PROOF = 0x0
VERIFIER_INVALID_PROOF = 0x1
VERIFIER_ERROR = 0x2

BACKENDS = ("torch", "oracle")


class ProverError(Exception):
    code = PROVER_ERROR


class InvalidWitnessLength(ProverError):
    code = PROVER_INVALID_WITNESS_LENGTH


def _as_u8(buf) -> np.ndarray:
    if isinstance(buf, np.ndarray):
        return buf.view(np.uint8)
    return np.frombuffer(buf, dtype=np.uint8)


# -- size queries (src/prover.cpp:55-71, 842-889) ---------------------------

def groth16_proof_size() -> int:
    return C.PROOF_BUFFER_MIN_SIZE


def ultra_groth_proof_size() -> int:
    return C.PROOF_BUFFER_MIN_SIZE_ULTRAGROTH


def groth16_public_size_for_zkey_buf(zkey_buffer) -> int:
    zk = parse_groth16_zkey(_as_u8(zkey_buffer))
    return C.public_buffer_min_size(zk.n_public)


def ultra_groth_public_size_for_zkey_buf(zkey_buffer) -> int:
    zk = parse_ultragroth_zkey(_as_u8(zkey_buffer))
    return C.public_buffer_min_size(zk.n_public - 1)


def groth16_public_size_for_zkey_file(path) -> int:
    return groth16_public_size_for_zkey_buf(open(path, "rb").read())


def ultra_groth_public_size_for_zkey_file(path) -> int:
    return ultra_groth_public_size_for_zkey_buf(open(path, "rb").read())


# -- prover object API (create / prove / destroy) ---------------------------

def _check_prime(prime: int):
    if prime != FR_MODULUS:
        raise ProverError("zkey curve not supported")


def _check_backend(backend: str):
    if backend not in BACKENDS:
        raise ProverError(f"unknown backend {backend!r}")


def _device(device):
    from .runtime import default_device
    return default_device() if device is None else device


def _make_mesh(devices, device):
    """devices: None -> single-device; int/"all" -> 1-D data mesh of the
    platform of `device`."""
    if devices is None:
        return None
    from .parallel import make_mesh
    return make_mesh(devices, device=device)


class Groth16Prover:
    """Handle-style prover: parse and upload once, prove many (parity:
    groth16_prover_create / _prove / _destroy, src/prover.cpp:144-216).
    device: where the `torch` backend proves (default
    `runtime.default_device()`); devices: shard the prove over that many
    devices of its platform (`_make_mesh`)."""

    def __init__(self, zkey_buffer, backend: str = "torch", device=None,
                 devices=None):
        _check_backend(backend)
        self.zk = parse_groth16_zkey(_as_u8(zkey_buffer))
        _check_prime(self.zk.r_prime)
        self.backend = backend
        if backend == "torch":
            from .protocol.prover import TorchGroth16Prover
            dev = _device(device)
            self._prover = TorchGroth16Prover(
                self.zk, device=dev, mesh=_make_mesh(devices, dev))
        else:
            self._prover = g16.OracleGroth16Prover(self.zk)

    @classmethod
    def from_file(cls, path, backend: str = "torch", device=None,
                  devices=None):
        return cls(open(path, "rb").read(), backend=backend, device=device,
                   devices=devices)

    def prove(self, wtns_buffer, r=None, s=None,
              abort_check=None) -> tuple[str, str]:
        """-> (proof_json, public_json).  Witness validation parity:
        src/prover.cpp:187-199.  abort_check: optional callable polled at
        the phase marks (torch backend); True -> trace.ProveAborted."""
        wt = parse_wtns(_as_u8(wtns_buffer))
        if wt.n_vars != self.zk.n_vars:
            raise InvalidWitnessLength(
                f"Invalid witness length. Circuit: {self.zk.n_vars}, "
                f"witness: {wt.n_vars}")
        _check_prime(wt.prime)
        kw = ({"abort_check": abort_check}
              if abort_check is not None and self.backend == "torch" else {})
        proof = self._prover.prove(wt.values, r=r, s=s, **kw)
        publics = array_to_ints(wt.values[1:self.zk.n_public + 1])
        return proof.to_json(), json.dumps([str(v) for v in publics])

    def public_buffer_min_size(self) -> int:
        return C.public_buffer_min_size(self.zk.n_public)

    def proof_buffer_min_size(self) -> int:
        return C.PROOF_BUFFER_MIN_SIZE


class UltraGrothProver:
    """Parity: ultra_groth_prover_create / _prove (src/prover.cpp:219-309).
    device, devices as for `Groth16Prover`."""

    def __init__(self, zkey_buffer, backend: str = "torch", device=None,
                 devices=None):
        _check_backend(backend)
        self.zk = parse_ultragroth_zkey(_as_u8(zkey_buffer))
        _check_prime(self.zk.r_prime)
        self.backend = backend
        if backend == "torch":
            from .protocol.prover import TorchUltraGrothProver
            dev = _device(device)
            self._prover = TorchUltraGrothProver(
                self.zk, device=dev, mesh=_make_mesh(devices, dev))
        else:
            self._prover = ug.OracleUltraGrothProver(self.zk)

    @classmethod
    def from_file(cls, path, backend: str = "torch", device=None,
                  devices=None):
        return cls(open(path, "rb").read(), backend=backend, device=device,
                   devices=devices)

    def prove(self, uwtns_buffer, r0=None, r=None, s=None,
              abort_check=None) -> tuple[str, str]:
        wt = parse_wtns(_as_u8(uwtns_buffer))
        if wt.n_vars != self.zk.n_vars:
            raise InvalidWitnessLength(
                f"Invalid witness length. Circuit: {self.zk.n_vars}, "
                f"witness: {wt.n_vars}")
        _check_prime(wt.prime)
        if wt.chunks is None:
            raise ProverError("uwtns lookup sections (3-6) missing")
        kw = ({"abort_check": abort_check}
              if abort_check is not None and self.backend == "torch" else {})
        proof, w_final = self._prover.prove(wt.values, wt, r0=r0, r=r, s=s,
                                            **kw)
        publics = ug.public_signals(w_final, self.zk.n_public,
                                    self.zk.rand_indx)
        return proof.to_json(), json.dumps([str(v) for v in publics])

    def public_buffer_min_size(self) -> int:
        return C.public_buffer_min_size(self.zk.n_public - 1)

    def proof_buffer_min_size(self) -> int:
        return C.PROOF_BUFFER_MIN_SIZE_ULTRAGROTH


# -- one-shot provers (src/prover.cpp:682-767) ------------------------------

def groth16_prover(zkey_buffer, wtns_buffer, backend="torch",
                   device=None, devices=None) -> tuple[str, str]:
    return Groth16Prover(zkey_buffer, backend=backend, device=device,
                         devices=devices).prove(wtns_buffer)


def ultra_groth_prover(zkey_buffer, uwtns_buffer, backend="torch",
                       device=None, devices=None) -> tuple[str, str]:
    return UltraGrothProver(zkey_buffer, backend=backend, device=device,
                            devices=devices).prove(uwtns_buffer)


# -- verifiers (src/verifier.cpp:149-237) -----------------------------------

def groth16_verify(proof_json: str, inputs_json: str, vk_json: str) -> int:
    """Returns VERIFIER_VALID_PROOF / INVALID_PROOF / ERROR."""
    try:
        proof = g16.Proof.from_json_dict(json.loads(proof_json))
        inputs = [int(v) for v in json.loads(inputs_json)]
        vk = g16.VerificationKey.from_json_dict(json.loads(vk_json))
        ok = g16.verify(proof, inputs, vk)
    except Exception:
        return VERIFIER_ERROR
    return VERIFIER_VALID_PROOF if ok else VERIFIER_INVALID_PROOF


def ultra_groth_verify(proof_json: str, inputs_json: str, vk_json: str) -> int:
    try:
        proof = ug.UltraGrothProof.from_json_dict(json.loads(proof_json))
        inputs = [int(v) for v in json.loads(inputs_json)]
        vk = ug.UltraGrothVerificationKey.from_json_dict(json.loads(vk_json))
        ok = ug.verify(proof, inputs, vk)
    except Exception:
        return VERIFIER_ERROR
    return VERIFIER_VALID_PROOF if ok else VERIFIER_INVALID_PROOF
