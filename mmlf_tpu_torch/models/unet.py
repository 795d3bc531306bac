"""U-Net output network (``--model_unet``).

The counterpart of ``mmlf_tpu.models.unet`` (``UNetConvBlock``,
``UNetUpBlock``, ``UNet``), in NCHW with the module names of the reference
torch U-Net, so a reference ``--model_unet`` ``checkpoint.pt`` loads
strictly:

  ``down_path.<i>.block.{0,3}``             the two 3×3 convs of a block,
  ``down_path.<i>.block.{2,5}``             their BatchNorms (conv → ReLU →
                                            BN, twice; 1 and 4 the ReLUs),
  ``up_path.<j>.up``                        the 2×2 stride-2 transposed conv,
  ``up_path.<j>.conv_block.block.{0,2,3,5}`` the block after the skip,
  ``last``                                  the 1×1 conv to the head.

``up_path[j]`` serves level ``i = depth - 2 - j`` (the JAX module's
``up{i}``).  The skip connection is centre-cropped to the upsampled size
and concatenated after it; the 2×2 max-pools floor odd sizes, so an input
whose side is not a multiple of ``2 ** (depth - 1)`` comes out smaller, as
in the JAX package.  BatchNorm is ``ops/batchnorm.BatchNorm2d`` with
torch's default momentum 0.1 (flax 0.9), whatever
``model_batchnorm_momentum`` says, as in the JAX package.

``dtype=torch.bfloat16`` (``--bf16``) rounds where the JAX module does:
each conv and transposed conv takes bf16 input and bf16 weights and adds
its bias in bf16, BatchNorm normalizes bf16 activations (its bf16 path),
and the last 1×1 conv runs in float32 on the upcast activations.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.batchnorm import BatchNorm2d


def _conv(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A conv or transposed conv of ``x`` in ``x``'s dtype: the weights
    cast to it, the bias added after the conv (the JAX package's two
    roundings in bf16; one call in float32)."""
    if x.dtype == torch.float32:
        return layer(x)
    w, b = layer.weight.to(x.dtype), layer.bias.to(x.dtype)[:, None, None]
    if isinstance(layer, nn.ConvTranspose2d):
        return F.conv_transpose2d(x, w, None, layer.stride) + b
    return F.conv2d(x, w, None, layer.stride, layer.padding) + b


class UNetConvBlock(nn.Module):
    """[3×3 conv → ReLU → BN] twice (``padding``: 1, else 0)."""

    def __init__(self, cin: int, cout: int, padding: bool = True,
                 batch_norm: bool = True):
        super().__init__()
        p = int(padding)
        layers = [nn.Conv2d(cin, cout, 3, padding=p), nn.ReLU()]
        if batch_norm:
            layers.append(BatchNorm2d(cout, momentum=0.1))
        layers += [nn.Conv2d(cout, cout, 3, padding=p), nn.ReLU()]
        if batch_norm:
            layers.append(BatchNorm2d(cout, momentum=0.1))
        self.block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.block:
            x = _conv(layer, x) if isinstance(layer, nn.Conv2d) else \
                layer(x)
        return x


class UNetUpBlock(nn.Module):
    """2×2 stride-2 transposed conv, the centre-cropped skip concatenated
    after it, then a ``UNetConvBlock``."""

    def __init__(self, cin: int, cout: int, padding: bool = True,
                 batch_norm: bool = True):
        super().__init__()
        self.up = nn.ConvTranspose2d(cin, cout, 2, stride=2)
        self.conv_block = UNetConvBlock(cin, cout, padding, batch_norm)

    def forward(self, x: torch.Tensor, bridge: torch.Tensor) -> torch.Tensor:
        up = _conv(self.up, x)
        dh = (bridge.shape[2] - up.shape[2]) // 2
        dw = (bridge.shape[3] - up.shape[3]) // 2
        bridge = bridge[:, :, dh:dh + up.shape[2], dw:dw + up.shape[3]]
        return self.conv_block(torch.cat([up, bridge], 1))


class UNet(nn.Module):
    """The U-Net of the reference with ``depth`` levels of ``2**(wf+i)``
    channels (``up_mode='upconv'``)."""

    def __init__(self, cin: int, n_classes: int, depth: int = 5,
                 wf: int = 6, padding: bool = True, batch_norm: bool = True):
        super().__init__()
        self.down_path = nn.ModuleList()
        prev = cin
        for i in range(depth):
            self.down_path.append(UNetConvBlock(prev, 2 ** (wf + i),
                                                padding, batch_norm))
            prev = 2 ** (wf + i)
        self.up_path = nn.ModuleList()
        for i in reversed(range(depth - 1)):
            self.up_path.append(UNetUpBlock(prev, 2 ** (wf + i), padding,
                                            batch_norm))
            prev = 2 ** (wf + i)
        self.last = nn.Conv2d(prev, n_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for i, down in enumerate(self.down_path):
            x = down(x)
            if i != len(self.down_path) - 1:
                skips.append(x)
                x = F.max_pool2d(x, 2)
        for j, up in enumerate(self.up_path):
            x = up(x, skips[-j - 1])
        # the head's 1x1 conv runs in the parameters' dtype, float32 (the
        # JAX module's dtype there), whatever the trunk's
        return self.last(x.to(self.last.weight.dtype))
