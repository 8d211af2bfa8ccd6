"""PyTorch / CUDA port of laser_slam_tpu (2D laser SLAM).

The package mirrors ``laser_slam_tpu``'s layout and public names; it
imports ``torch`` and numpy and never ``jax`` (nor ``laser_slam_tpu``,
whose package import pulls in jax). Functions take tensors batched along
a leading dimension and run on the device of their inputs. The fused PSM
matcher is a hand-written CUDA kernel (``csrc/psm_kernel.cu``, bound in
``ops/cuda/psm_kernel.py``) that builds with ``nvcc`` at first use.
"""
