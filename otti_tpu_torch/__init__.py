"""PyTorch/CUDA port of otti_tpu: LP, SDP and SGD optimality certificates
proved on one GPU by the Spartan NIZK (zero-knowledge or transparent) or in
SNARK mode.

Plain tensor code is torch; the field multiply and the sumcheck round are
hand-written CUDA kernels (``csrc/``), built at first use.  The JAX package
``otti_tpu`` stays the reference this package is held against; this
package never imports jax.
"""
