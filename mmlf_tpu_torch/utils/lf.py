"""Dump view stacks as PNGs."""

from __future__ import annotations

import os

from .imgio import save_img


def save_views(scene_dir: str, h_views, v_views, i_views=None, d_views=None):
    """Write ``view_{h,v,i,d}_{j}.png`` for every view of each stack.

    Stacks are ``(n, H, W, 3)`` (a leading batch dimension is stripped).
    """
    os.makedirs(scene_dir, exist_ok=True)

    def dump(stack, tag):
        if stack is None:
            return
        if stack.ndim == 5:
            stack = stack[0]
        for j in range(stack.shape[0]):
            save_img(os.path.join(scene_dir, f'view_{tag}_{j}.png'),
                     stack[j])

    dump(h_views, 'h')
    dump(v_views, 'v')
    dump(i_views, 'i')
    dump(d_views, 'd')
