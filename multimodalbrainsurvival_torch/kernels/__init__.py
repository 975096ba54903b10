"""Hand-written Hopper kernels of the port, each beside its plain version.

``build.py`` compiles ``csrc/*.cu``; each kernel module holds the wrapper
(dispatch on the input's device, launch counter) and the plain PyTorch
version the CPU path and the tests use.
"""
