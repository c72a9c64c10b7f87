"""Kernels (`ops/blend.py`, `csrc/blend.cu`): K2's (backward blend) share of
its roofline over the sampled window launches."""

from ._roofline import share


def read(ctx):
    return share(ctx, "K2")
