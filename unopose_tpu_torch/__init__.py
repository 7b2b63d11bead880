"""PyTorch / CUDA port of UNOPose inference, its evaluation entry point
(``main_unopose.py --eval-only``) and its training step for one NVIDIA H100.

Mirrors the layout of the JAX package ``unopose_tpu`` (``ops/``,
``models/``, ``engine/``, ``data/``, ``eval/``, ``utils/``, ``losses.py``,
``main_unopose.py``), which stays the reference; ``kernels/`` holds the
hand-written sm_90a CUDA kernels that replace the TPU's Pallas kernels on
these paths, ``native/`` the C++ host library of the test reader and the
evaluator; ``configs.py`` holds the configurations it runs. Imports torch
and numpy only, and nothing of the JAX package.

Float32 products stay full float32: pairwise distances, LRFs and solvers
lose their accuracy under TF32 (a truncated cross term cancels
catastrophically), so importing the package turns TF32 off for matmuls and
cuDNN.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
