"""Key bytes in memory to a constructed prover (`api.*Prover(zkey_bytes,
device="cuda")`), ending in `torch.cuda.synchronize()`: the parse, the
upload and the prover's set-up on the card."""


def read(ctx):
    return ctx["key_load_s"]
