from . import binfile, fieldenc, wtns, zkey  # noqa: F401
