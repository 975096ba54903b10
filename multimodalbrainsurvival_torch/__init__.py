"""PyTorch / CUDA port of ``multimodalbrainsurvival_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference each module is held
against. This package imports neither ``jax`` nor anything of the JAX
package; where it needs one of that package's framework-free modules it
keeps its own copy. Module names follow the JAX package so each counterpart
is easy to find.

Entry points run on ``cuda`` unless the caller asks for ``cpu``
(``device.resolve_device``). On a CPU tensor every kernel wrapper uses its
plain PyTorch version; on a CUDA tensor it launches its hand-written kernel.
"""
