"""Hand-written Hopper kernels, one folder each: ``csrc/`` (CUDA C++),
``ops.py`` (wrappers and launch counts), ``ref.py`` (plain PyTorch)."""
