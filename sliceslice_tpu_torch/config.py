"""Constants shared across the port.

The JAX package's config also sets up a jax compile cache and an
interpreter switch.  The port has neither: PyTorch runs eagerly, and each
kernel wrapper chooses its kernel or its plain PyTorch version by the
device of the tensor it is given — a CUDA tensor always reaches the kernel.
"""

#: "no match" sentinel for first-offset results (int32 max), as in the JAX
#: package.
SENTINEL = 2**31 - 1

#: Needle rows per table block, the JAX package's ``NEEDLE_BLOCK``.  The
#: CUDA kernel has no needle blocks; the port keeps the value so that
#: ``plan_block`` pads tables to the same row counts as the JAX package.
NEEDLE_BLOCK = 256
