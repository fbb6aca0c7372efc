"""PyTorch + CUDA port of categoricalnf_tpu for NVIDIA Hopper.

The set-modeling, graph-coloring and language-modeling families: training,
sampling, IS bits/var evaluation and the HTTP server.  The JAX package
``categoricalnf_tpu`` is the reference; this package imports nothing of
it.  Entry points run on the card unless the caller passes
``device="cpu"``.
"""
