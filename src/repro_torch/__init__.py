"""PyTorch/CUDA port of the INTERACT reproduction (package ``repro``).

The port mirrors ``src/repro/`` module by module; the JAX package stays
the reference it is tested against.  This package imports torch and
numpy, never JAX and nothing of ``repro``.  Two paths run: INTERACT
(``repro_torch.solvers.solve``, ``default_setup``) and LM serving
(``repro_torch.launch.serving``, ``repro_torch.models.model``).  Their
entry points run on the CUDA card unless the caller passes
``device="cpu"``.  The TPU kernels on those paths (consensus, flash
attention, WKV6) are hand-written CUDA for Hopper under
``kernels/*/csrc``, built with ``nvcc`` at first use.
"""
