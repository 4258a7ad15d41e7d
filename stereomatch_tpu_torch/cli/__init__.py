"""Command-line entry points of the port, run as modules:

    python -m stereomatch_tpu_torch.cli.evaluate ...

``stm-eval``'s and ``stm-image``'s counterparts (``evaluate``,
``image``) are ported; the other CLIs come with later slices (ROADMAP
A.13).  The console
scripts of ``pyproject.toml`` stay bound to the JAX package.
"""
