"""The plain reference: EPC-Net and EPC-Net-L in fp32 (``model.py``), exact
retrieval in fp64 (``retrieval.py``) and the training step (``train.py``),
in plain PyTorch with TF32 off. It imports nothing of ``epcnet_torch``, JAX
or the JAX package, and takes nothing the program made: it is given the
benchmark's own inputs and weights.

``precision.py`` holds the control's lower precision: the reference put in
the program's place with its bf16 products in fp8 (e4m3, one scale a
tensor) and its fp32 products in TF32, which the correctness check has to
refuse.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
