"""Command-line entry points of the port, run as modules; every one runs
on the card unless ``--device cpu`` is given:

    python -m stereomatch_tpu_torch.cli.image left.png right.png 64 out.png
    python -m stereomatch_tpu_torch.cli.evaluate --synthetic 2
    python -m stereomatch_tpu_torch.cli.video y4m teddy.y4m 128 \
        --headless --batch 4
    python -m stereomatch_tpu_torch.cli.serve 128 -cm ssd --batch 8 \
        --warmup 375x450
    python -m stereomatch_tpu_torch.cli.fetch teddy2003 --dest data

``image``, ``evaluate``, ``video``, ``serve`` and ``fetch`` are the
counterparts of ``stm-image``, ``stm-eval``, ``stm-video``, ``stm-serve``
and ``stm-fetch``.  On the CPU, e.g. ``python -m
stereomatch_tpu_torch.cli.video imgdir frames/ 64 --headless --device
cpu``; ``serve`` then answers ``curl --data-binary @sbs.png
'localhost:8792/estimate?format=npy'``.  ``--mesh`` on ``video`` and
``serve`` lays out this process's devices (every visible card, or 8 CPU
devices with ``--device cpu``), whatever ``WORLD_SIZE`` a launcher
sets, as the JAX CLIs do.  The console
scripts of ``pyproject.toml`` stay bound to the JAX package.
"""
