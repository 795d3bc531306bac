"""Row-split inference over the ranks of a process group (``--mesh_space``).

The JAX package shards each scene's H over a ``space`` mesh axis and leaves
every conv's halo exchange to XLA, so its outputs are the whole scene's.
Here each rank cuts its slab of the WHOLE scene, rows ``[r0 − halo, r1 +
halo) ∩ [0, H)`` with ``halo`` the net's receptive radius
(``parallel/mesh.row_share``), runs the net on it and keeps its rows
``[r0, r1)``: with a halo of at least the receptive radius, zero padding
only ever meets the true image border, so the kept rows equal the whole
scene's there.  ``gather_rows`` concatenates every rank's rows.

Under ``--val_ensamble`` each member's EPI shift is applied to the whole
scene before the slab is cut (``SlabForward`` is the ensemble's model), so
the shift wraps at the scene's edge, as in the whole-scene run (cutting
first would give ``--val_tile``'s border-band deviation, which the JAX
package's ``--mesh_space`` does not have).  The members' selection is
per pixel, and kernel K2 runs on each rank's own rows; the mean, logvar,
member stacks and posterior are then gathered once a scene.

A U-Net net (``--model_unet``) runs as the JAX package runs it: its slabs
start and end at multiples of 16 (its four 2×2 max-pools keep the whole
scene's pooling grid) and its halo covers its receptive field
(``tiling.unet_halo``).

Outputs with no spatial extent (the INN's per-image ``jac``, its ``mu``)
come back as None: a slab's ``jac`` is not the scene's, and no metric or
artifact reads either.
"""

from __future__ import annotations

import torch

from ..parallel import mesh
from .tiling import probe_spatial, spatial_dims


class SlabForward:
    """``fn`` on this rank's slab of whole-scene stacks ``(b, n, H, W,
    3)``; returns the outputs' kept rows.  ``probe`` finds the spatial
    outputs with a second, smaller forward (``tiling.probe_spatial``), once
    a slab shape; ``align`` widens the slab's ends to its multiples."""

    def __init__(self, fn, halo: int, probe: bool = False, align: int = 1):
        self.fn = fn
        self.halo = halo
        self.probe = probe
        self.align = align
        self._sdim = {}

    def __call__(self, *stacks) -> dict:
        h = stacks[0].shape[2]
        r0, r1, s0, s1 = mesh.row_share(h, mesh.rank(), mesh.world(),
                                        self.halo, self.align)
        slab = [None if s is None else s[:, :, s0:s1] for s in stacks]
        out = self.fn(*slab)
        key = tuple(slab[0].shape[2:4])
        if key not in self._sdim:
            self._sdim[key] = probe_spatial(self.fn, slab, out, self.probe)
        sdim = self._sdim[key]
        return {k: None if sdim[k] is None else v.narrow(sdim[k], r0 - s0,
                                                         r1 - r0)
                for k, v in out.items()}


@torch.no_grad()
def gather_rows(out: dict, rows: int, width: int) -> dict:
    """Every rank's ``rows`` kept rows of each output (its ``(rows,
    width)`` pair) concatenated in rank order: the whole scene's outputs,
    on every rank."""
    return {k: None if v is None else
            mesh.gather_dim(v.contiguous(),
                            spatial_dims(v.shape, (rows, width)))
            for k, v in sorted(out.items())}
