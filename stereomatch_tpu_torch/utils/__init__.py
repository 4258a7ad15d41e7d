from . import backend, numeric, profiling, validation, viz

__all__ = ["backend", "numeric", "profiling", "validation", "viz"]
