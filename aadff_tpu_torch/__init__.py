"""PyTorch/CUDA port of `aadff_tpu` for NVIDIA Hopper.

The JAX package `aadff_tpu` is the reference this package is held to; this
package never imports it (nor JAX, Flax or msgpack).  Entry points take
`device="cuda"` by default; the CPU runs the plain PyTorch versions of the
hand-written kernels, which is what the tests use.
"""
