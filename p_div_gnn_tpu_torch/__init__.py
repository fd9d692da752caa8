"""P-DivGNN serving on NVIDIA Hopper: the PyTorch/CUDA counterpart of
``p_div_gnn_tpu``.

This package imports torch, numpy, scipy and the standard library only.
Host-side graph construction and batching are numpy copies of the JAX
package's modules; the model is ``torch.nn``; the one hand-written kernel
(``ops/fused_edge3.py`` + ``csrc/fused_edge3_fwd.cu``) is built with nvcc
at first use and bound with ctypes. Entry points default to
``device="cuda"``; pass ``device="cpu"`` to run the plain PyTorch versions.
"""
