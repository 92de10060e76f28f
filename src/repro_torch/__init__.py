"""PyTorch/CUDA port of the INTERACT reproduction (package ``repro``).

The port mirrors ``src/repro/`` module by module; the JAX package stays
the reference it is tested against.  This package imports torch and
numpy, never JAX and nothing of ``repro``.  Its entry points
(``repro_torch.solvers.solve``, ``default_setup``) run on the CUDA card
unless the caller passes ``device="cpu"``.  The consensus kernels are
hand-written CUDA for Hopper (``kernels/consensus_step/csrc``), built
with ``nvcc`` at first use.
"""
