"""PyTorch/CUDA port of ``heuristique_style_transfer_code_tpu`` for NVIDIA
Hopper (H100).

The package mirrors the JAX package's layout so that every module has a
counterpart of the same name. It imports ``torch`` and never ``jax`` nor the
JAX package. Public functions keep the JAX layout (NHWC in, NHWC out);
inside, convolutions run in ``channels_last`` memory format, so the
(N, HW, C) view that the hand-written Gram kernels (``csrc/gram.cu``) take
is free. Entry points run on ``cuda`` unless the caller asks for ``cpu``.
"""
