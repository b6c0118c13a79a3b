"""PyTorch/CUDA port of cremage_tpu for NVIDIA Hopper GPUs.

A second package beside the JAX one, which stays the reference. It imports
torch and never jax or any module of cremage_tpu. Module paths mirror the
JAX package; the two Pallas kernels are hand-written CUDA in csrc/.
"""
