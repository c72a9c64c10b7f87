"""Kernels (`ops/blend.py`, `csrc/blend.cu`): K1's (forward blend) share of
its roofline over the sampled window launches."""

from ._roofline import share


def read(ctx):
    return share(ctx, "K1")
