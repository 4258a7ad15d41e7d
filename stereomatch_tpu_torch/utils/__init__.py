from . import backend, benchmarking, numeric, profiling, validation, viz

__all__ = ["backend", "benchmarking", "numeric", "profiling", "validation",
           "viz"]
