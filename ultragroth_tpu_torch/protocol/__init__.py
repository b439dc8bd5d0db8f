from . import groth16, quotient, transcript  # noqa: F401
