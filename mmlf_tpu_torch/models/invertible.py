"""The reference's invertible-network path (``--model_invertible``):
disabled, as in the reference and the JAX package.

Its INN ("zixels" + GMM readout) is dead code upstream: the CLIs comment
out its imports and training raises ``NotImplementedError('INNs are not
supported anymore')``.  The flag exists for CLI parity and fails the
same way; the working invertible network is ``--model_inn``
(``models/inn.py``).
"""

from __future__ import annotations

NOT_SUPPORTED_MSG = 'INNs are not supported anymore'


class Invertible:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(NOT_SUPPORTED_MSG)


class ZixelWrapper:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(NOT_SUPPORTED_MSG)
