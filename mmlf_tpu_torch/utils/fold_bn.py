"""Fold eval-mode BatchNorm into the preceding convolution.

At inference BN is an affine map with frozen statistics,
``y = w * (x - mean) / sqrt(var + eps) + b``.  Each block ends
``conv2 → BN`` (index 2 → 3), so the BN folds exactly into conv2's weight
(OIHW: the scale runs along axis 0) and bias — one fewer full-activation
pass per block, which the 70-member ensemble pays 70 times per scene.
"""

from __future__ import annotations

import torch

BN_EPS = 1e-5


def fold_batchnorm(state_dict: dict) -> dict:
    """Return an eval-equivalent state dict with every block BN folded away,
    for the same model built with ``model_no_batchnorm=True``."""
    # keys are '<net>.<block>.<layer>.<param>'; layer 3 is the BN
    out = {k: v for k, v in state_dict.items() if k.split('.')[2] != '3'}
    for key in state_dict:
        if not key.endswith('.3.running_var'):
            continue
        block = key[:-len('.3.running_var')]
        w = state_dict[f'{block}.3.weight'].float()
        beta = state_dict[f'{block}.3.bias'].float()
        mean = state_dict[f'{block}.3.running_mean'].float()
        var = state_dict[f'{block}.3.running_var'].float()
        s = w / torch.sqrt(var + BN_EPS)
        conv_w = state_dict[f'{block}.2.weight'].float()
        conv_b = state_dict[f'{block}.2.bias'].float()
        out[f'{block}.2.weight'] = conv_w * s[:, None, None, None]
        out[f'{block}.2.bias'] = (conv_b - mean) * s + beta
    return out
