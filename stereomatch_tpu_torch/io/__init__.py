"""Host-side I/O: numpy-only modules, copied from the JAX package so the
port runs where JAX is not installed."""

from . import synthetic

__all__ = ["synthetic"]
