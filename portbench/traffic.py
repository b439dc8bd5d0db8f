"""The one traffic generator: a mix is a JSON file of parameters under
`traffic/`, read here.

Keys of a mix:
  loop        the caller loop that sends the proves, `loops/<loop>.py`
              ("closed": one caller, the next prove as soon as the last
              one returned)
  pool        witnesses made in set-up from the seed and cycled through
  warmup      proves before the window, from their own blinding stream
  check       proves of the window held against the reference, drawn from
              the seed (all of them when the window has fewer)
A loop may read keys of its own from the same file.

The witnesses themselves come from the configuration's circuit kind
(`circuits.<kind>.witness`); each prove's blinding scalars (r, s; r0 as
well in UltraGroth) are 31 random bytes, as the program draws its own,
from a stream of the seed."""
from __future__ import annotations

import random


def validate(mix: dict) -> dict:
    if not isinstance(mix.get("loop"), str):
        raise ValueError(f"traffic: no loop named in {mix}")
    for key in ("pool", "warmup", "check"):
        if int(mix[key]) < (0 if key == "warmup" else 1):
            raise ValueError(f"traffic: {key} = {mix[key]}")
    return mix


def stream(seed: int, name: str) -> random.Random:
    """An independent random stream of the seed (any size of int)."""
    return random.Random(f"{seed}:{name}")


def pool(circuit, dep, mix: dict, seed: int) -> list:
    rng = stream(seed, "pool")
    return [circuit.witness(dep, rng) for _ in range(int(mix["pool"]))]


def blinding(protocol: str, rng: random.Random):
    """Endless per-prove blinding scalars."""
    names = ("r", "s") if protocol == "groth16" else ("r0", "r", "s")
    while True:
        yield {n: rng.getrandbits(248) for n in names}
