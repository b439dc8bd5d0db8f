"""Process start to the first timed prove: interpreter, torch, the CUDA
context, the kernel libraries, the key read from the benchmark's cache,
the prover's set-up, the witness pool and the warm-up proves.  The key's
build, which only a checkout's first run does, is left out."""


def read(ctx):
    return ctx["setup_s"]
