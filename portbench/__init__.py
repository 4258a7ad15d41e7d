"""The benchmark of ``stereomatch_tpu_torch`` on one NVIDIA GPU.

``python portbench/run.py --workload <config>.<traffic> --seed N
--seconds S --trace 0|1`` streams seeded uint8 stereo frames through
``stereomatch_tpu_torch.stream.StreamingEstimator``, judges the yielded
disparities against the plain reference in ``portbench/reference/``,
and prints one JSON result line.  See ``portbench/README.md``.
"""
