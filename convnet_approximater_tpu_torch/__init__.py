"""PyTorch/CUDA port of convnet_approximater_tpu for NVIDIA Hopper.

The JAX package beside it is the reference this port is held against.  This
package imports torch and never jax.
"""

__version__ = "0.1.0"
