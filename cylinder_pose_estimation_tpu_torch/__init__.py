"""PyTorch + CUDA port of the laser-grid cylinder pose estimation system.

The JAX package ``cylinder_pose_estimation_tpu`` beside it is the reference;
module paths here mirror it.  The three front-end kernels of the detection
path are hand-written CUDA C++ for Hopper (``csrc/``), each with a plain
PyTorch version in ``ops/frontend.py``: a CUDA tensor launches the kernel, a
CPU tensor runs the plain version.  Entry point:
``models.pipeline.estimate_poses_batch``.
"""
