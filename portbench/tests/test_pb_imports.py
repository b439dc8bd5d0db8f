"""Nothing the harness runs imports JAX or the JAX package, and the
reference imports neither nor the port: each checked in a subprocess in
which those top-level names cannot be imported (compared whole:
`ultragroth_tpu_torch` begins with `ultragroth_tpu`)."""
import subprocess
import sys

from portbench import bench

BLOCK = """
import importlib.abc, sys
BLOCKED = {blocked!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
"""

HARNESS = ["portbench.run", "portbench.bench", "portbench.control",
           "portbench.repeat", "portbench.keygen", "portbench.traffic",
           "portbench.loops", "portbench.loops.closed",
           "portbench.trace", "portbench.work", "portbench.circuits.lookup",
           "portbench.circuits.square_chain", "ultragroth_tpu_torch.api",
           "ultragroth_tpu_torch.ops.kernels"]
REFERENCE = ["portbench.reference.prover", "portbench.reference.quotient",
             "portbench.reference.field", "portbench.reference.curve",
             "portbench.reference.keccak"]


def _run(blocked, modules, extra=""):
    code = BLOCK.format(blocked=set(blocked)) + "".join(
        f"import {m}\n" for m in modules) + extra + (
        "tops = {n.split('.')[0] for n in sys.modules}\n"
        f"assert not tops & {set(blocked)!r}, tops\n")
    p = subprocess.run([sys.executable, "-c", code],
                       cwd=bench.HERE.parent, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]


def test_harness_imports_no_jax():
    readers = "".join(
        f"from portbench import bench as _b; _b.reader({p.stem!r})\n"
        for p in (bench.HERE / "metrics").glob("[!_]*.py"))
    _run(["jax", "jaxlib", "flax", "ultragroth_tpu"], HARNESS, readers)


def test_reference_imports_no_program():
    _run(["jax", "jaxlib", "flax", "ultragroth_tpu", "ultragroth_tpu_torch"],
         REFERENCE)
