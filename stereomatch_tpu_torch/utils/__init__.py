from . import backend, numeric, profiling, validation

__all__ = ["backend", "numeric", "profiling", "validation"]
