"""Pure math kernels (quaternions, splines, lens, robust loss).

JAX rebuild of the reference's `rssync_coresupport` layer
(ref: src/core_support/). All functions are batched jax.numpy ops that
broadcast over arbitrary leading axes.
"""
