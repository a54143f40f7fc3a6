"""PyTorch/CUDA port of the SOCCER distributed k-means system.

Mirrors the JAX package module for module and imports none of it. Entry
points run on the CUDA card unless the caller passes ``device="cpu"``;
the clustering kernels are hand-written CUDA C++ (``kernels/csrc``).

Importing the package pins CUDA float32 matrix products and convolutions
to full float32 (no TF32): the plain versions of the kernels take the
cross term ``x @ c.T`` through ``torch.matmul``, and TF32's ~3 decimal
digits would swamp the expanded distance form at the paper's σ = 0.001.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
