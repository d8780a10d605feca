"""PyTorch/CUDA port of the CoPRIS system.

The package mirrors ``repro``'s module names (``models.attention``,
``sampling.sampler``, ``core.rollout``, ``launch.serve`` ...) so each module's
counterpart is easy to find. It imports ``torch`` and never ``jax``, and
nothing of the JAX package. Hand-written Hopper kernels live under
``hopper/`` (Python wrappers) and ``csrc/`` (CUDA C++ sources).
"""
