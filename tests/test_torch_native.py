"""PyTorch port: the native host runtime (`native.py` over the unchanged
`native/ultragroth_io.cpp`, built by g++ into the port's build directory),
held against its plain versions (the port's Python Keccak, the torch
transpose, `io/binfile.py`'s parser) and against the JAX package's values.
"""
import numpy as np
import pytest
import torch

from ultragroth_tpu import keccak as jkeccak
from ultragroth_tpu.io.binfile import BinFile as JBinFile
from ultragroth_tpu.ops import limbs as jlb
from ultragroth_tpu_torch import keccak, native
from ultragroth_tpu_torch.io.binfile import BinFile
from ultragroth_tpu_torch.ops import limbs as lb
from ultragroth_tpu_torch.protocol.ultragroth import derive_challenge
from ultragroth_tpu_torch.testkit.circuits import square_chain_circuit
from ultragroth_tpu_torch.testkit.setup import groth16_setup


@pytest.fixture(scope="module")
def zkey_bytes():
    r1cs, _ = square_chain_circuit(5, seed=3)
    return groth16_setup(r1cs, seed=4).zkey_bytes


def test_native_runtime_builds():
    assert native.available()
    assert native.IO_SOURCE.exists()


@pytest.mark.parametrize("n", [0, 1, 64, 135, 136, 137, 272, 1000])
def test_native_keccak_matches_python_and_jax(n):
    data = np.random.default_rng(n).bytes(n)
    got = native.keccak256(data)
    assert got == keccak.keccak256_py(data) == jkeccak.keccak256(data)
    assert keccak.keccak256(data) == got


def test_challenge_without_the_library(monkeypatch):
    """Without the library every entry point answers None and the
    UltraGroth challenge takes the Python Keccak, to the same value."""
    point = (123456789, 987654321)
    want = derive_challenge(point)
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    assert native.keccak256(b"x") is None
    assert native.words_to_planes(np.zeros((1, 8), np.uint32)) is None
    assert native.binfile_scan(np.zeros(12, np.uint8)) is None
    assert native.load_file(__file__) is None
    assert derive_challenge(point) == want


def test_native_words_to_planes_matches_transpose_and_jax():
    rng = np.random.default_rng(5)
    words = rng.integers(0, 1 << 32, size=(300, 8), dtype=np.uint32)
    got = native.words_to_planes(words)
    assert got.dtype == np.uint32 and np.array_equal(got, words.T)
    halves = jlb.words_to_planes(words)            # the JAX [16, N] planes
    assert np.array_equal(got, halves[0::2] | (halves[1::2] << np.uint32(16)))


def test_cpu_upload_of_large_arrays_takes_the_native_repack(monkeypatch):
    words = np.random.default_rng(6).integers(
        0, 1 << 32, size=(lb.NATIVE_MIN_ROWS, 8), dtype=np.uint32)
    calls = []
    real = native.words_to_planes
    monkeypatch.setattr(native, "words_to_planes",
                        lambda w: calls.append(w.shape) or real(w))
    got = lb.words_to_planes(words, "cpu")
    assert calls == [words.shape]
    want = lb.words_to_tensor(words, "cpu").movedim(-1, 0).contiguous()
    assert got.dtype == torch.int64 and torch.equal(got, want)
    lb.words_to_planes(words[:100], "cpu")
    assert len(calls) == 1                        # small arrays stay in torch


def test_native_binfile_scan_matches_parsers(zkey_bytes):
    """The section table of the native scan equals the port's parser's and
    the JAX package's (type, offset, size), offsets from the file's
    start."""
    data = np.frombuffer(zkey_bytes, np.uint8)
    version, sections = native.binfile_scan(data)
    for parser in (BinFile, JBinFile):
        bf = parser.parse(zkey_bytes)
        assert version == bf.version
        assert sorted(sections) == sorted(
            (t, v.ctypes.data - data.ctypes.data, v.size)
            for t, views in bf.sections.items() for v in views)
    with pytest.raises(ValueError):
        native.binfile_scan(data[:40])


def test_native_load_file(tmp_path, zkey_bytes):
    path = tmp_path / "c.zkey"
    path.write_bytes(zkey_bytes)
    mapped = native.load_file(path)
    assert mapped.tobytes() == zkey_bytes
    assert not mapped.flags.writeable
    del mapped
    with pytest.raises(OSError):
        native.load_file(tmp_path / "missing.zkey")
