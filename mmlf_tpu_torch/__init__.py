"""mmlf_tpu_torch — the PyTorch/CUDA port of mmlf_tpu.

A second package beside ``mmlf_tpu`` (the JAX reference), with the same
module structure, names and array conventions at its public functions:
view stacks ``(b, n, H, W, 3)``, centre ``(H, W, 3)``, MPI ``(K, H, W, 5)``,
posteriors bins-last ``(..., H, W, S)``.  Inside the networks tensors are
NCHW, PyTorch's layout.

The package imports torch, numpy, PIL and click, and nothing of JAX or of
``mmlf_tpu``: what it needs from a JAX-free module there is copied here.
Every TPU kernel on a ported path is a hand-written CUDA kernel under
``csrc/``, built at first launch (``ops/kernels/build.py``); each wrapper
keeps a plain PyTorch version that it takes only for CPU tensors.

Entry points run on the card (``device='cuda'``) unless the caller asks for
the CPU, and raise when CUDA is asked for but absent.
"""

__version__ = "0.1.0"
