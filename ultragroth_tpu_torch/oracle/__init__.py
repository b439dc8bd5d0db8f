"""Python-int reference oracle: fields, curve, pairing.

Everything device-side is property-tested against this package.
"""
from . import field, curve, pairing  # noqa: F401
