"""P-DivGNN serving and training on NVIDIA Hopper: the PyTorch/CUDA
counterpart of ``p_div_gnn_tpu``.

This package imports torch, numpy, scipy and the standard library only.
Host-side graph construction, batching and the divergence operator are numpy
copies of the JAX package's modules; the model, losses and training step
are ``torch``; the hand-written kernels of the fused3 path (``csrc/``: the
edge step's forward and backward, the block-CSR segment sum) are built with
nvcc at first use and bound with ctypes. Entry points default to
``device="cuda"``; pass ``device="cpu"`` to run the plain PyTorch versions.
"""
