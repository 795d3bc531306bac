"""HCI 4D light-field dataset: scene loading and artifact writing.

The directory format of ``mmlf_tpu.data.hci4d``: scenes are subdirectories
holding 81 ``input_Cam*.png`` views (9×9 grid, row-major), a ground-truth
disparity PFM, an optional ``gt_mpi_lowres.npz`` multi-plane image, and an
optional ``mask.png``.

Layouts are channel-last numpy: view stacks ``(n, H, W, 3)``, centre
``(H, W, 3)``, gt ``(H, W)``, MPI ``(K, H, W, 5)`` (RGB, alpha, disparity),
mask ``(H, W)`` int32.  A sample is the 9-tuple
``(h_views, v_views, i_views, d_views, center, gt, mpi, mask, index)``.
"""

from __future__ import annotations

import copy
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np

from ..ops.masks import create_mask_texture
from ..trace import span
from ..utils import pfm
from ..utils.imgio import load_img, load_img_u8, save_img

# filename substrings that disqualify an image from being a view
_NON_VIEW_TOKENS = ('normals', 'mask', 'objectids', 'unused', 'edges',
                    'specular')

MAX_MPI_PLANES = 12


def cross_indices(nviews=(9, 9)):
    """Row-major grid indices of the four cross-hair stacks (horizontal,
    vertical, increasing diagonal bottom-left → top-right, decreasing
    diagonal) into the sorted 81-view list."""
    w, h = nviews
    horizontal = [(h // 2) * w + i for i in range(h)]
    vertical = [(w // 2) + w * i for i in range(h)]
    increasing = [w - i - 1 + w * i for i in range(h)][::-1]
    decreasing = [i + w * i for i in range(h)]
    return horizontal, vertical, increasing, decreasing


def _list_view_files(scene: str) -> list:
    files = sorted(f.name for f in os.scandir(scene))
    return [f for f in files
            if f.lower().endswith(('.png', '.jpg', '.jpeg'))
            and not any(t in f for t in _NON_VIEW_TOKENS)]


def _pick_gt_pfm(scene: str, nviews) -> Optional[str]:
    """The reference's cascade for locating the GT disparity PFM: prefer
    'disp', then 'lowres', then the centre view's index."""
    w, h = nviews
    pfms = sorted(f.name for f in os.scandir(scene)
                  if f.name.endswith('.pfm'))   # scandir order is fs-dependent
    if len(pfms) > 1:
        pfms = [f for f in pfms if 'disp' in f] or pfms
    if len(pfms) > 1:
        pfms = [f for f in pfms if 'lowres' in f] or pfms
    if len(pfms) > 1:
        center_idx = (h // 2) * w + (w // 2)
        pfms = [f for f in pfms if str(center_idx).zfill(3) in f] or pfms
    return os.path.join(scene, pfms[0]) if pfms else None


@span('mmlf.data.load_scene')
def load_scene(scene: str, nviews=(9, 9), index: int = 0,
               texture_mask: bool = True, raw_views: bool = False,
               threads: int = 0):
    """Load one scene directory into the 9-tuple sample (numpy float32).

    ``raw_views=True`` keeps the four view stacks as raw uint8 (the u8
    serving ingest normalizes them on the device); the centre is still
    float32 in [0, 1].  ``threads > 0`` decodes each needed view once (the
    four stacks share the centre view) on a thread pool of that size (PIL
    releases the GIL while it decodes).
    """
    imgs = _list_view_files(scene)
    hs, vs, inc, dec = cross_indices(nviews)
    load_one = load_img_u8 if raw_views else load_img

    if threads > 0:
        needed = sorted({i for idx in (hs, vs, inc, dec) for i in idx})
        with ThreadPoolExecutor(threads) as pool:
            decoded = dict(zip(needed, pool.map(
                lambda i: load_one(os.path.join(scene, imgs[i])), needed)))
    else:
        decoded = {}

    def stack(idx: Sequence[int]) -> np.ndarray:
        out = np.stack([(decoded[i] if i in decoded else
                         load_one(os.path.join(scene, imgs[i])))[..., :3]
                        for i in idx])
        return out if raw_views else out.astype(np.float32)

    h_views = stack(hs)
    v_views = stack(vs)
    i_views = stack(inc)
    d_views = stack(dec)

    center = v_views[nviews[1] // 2].astype(np.float32)
    if raw_views:
        center = center / 255.0

    gt_path = _pick_gt_pfm(scene, nviews)
    if gt_path is not None:
        gt = np.flip(pfm.load(gt_path), 0).astype(np.float32).copy()
    else:
        gt = np.zeros(center.shape[:2], dtype=np.float32)

    mpi_path = os.path.join(scene, 'gt_mpi_lowres.npz')
    if os.path.exists(mpi_path):
        # stored (H, W, K, 5) bottom-up → (K, H, W, 5) top-down
        with np.load(mpi_path) as npz:
            raw = npz['mpi']
        raw = np.flip(raw, 0)
        mpi = np.transpose(raw, (2, 0, 1, 3)).astype(np.float32)
        mpi = np.nan_to_num(mpi, nan=0.0)
        if mpi.shape[0] > MAX_MPI_PLANES:
            mpi = mpi[:MAX_MPI_PLANES]
        mpi = np.ascontiguousarray(mpi)
    else:
        # one-plane MPI synthesized from center + GT
        mpi = np.zeros((1,) + gt.shape + (5,), dtype=np.float32)
        mpi[0, ..., :3] = center
        mpi[0, ..., 3] = 1.0
        mpi[0, ..., 4] = gt

    mask_path = os.path.join(scene, 'mask.png')
    if os.path.exists(mask_path):
        m = load_img(mask_path)
        if m.ndim == 3:
            m = m[..., 0]
        mask = (m > 0).astype(np.int32)
    else:
        mask = np.ones_like(gt, dtype=np.int32)

    if texture_mask:
        mask = mask * create_mask_texture(center, 23, 0.02)

    return (h_views, v_views, i_views, d_views, center, gt, mpi, mask,
            np.atleast_1d(index))


def pad_mpi(mpi: np.ndarray, k: int = MAX_MPI_PLANES) -> np.ndarray:
    """Zero-alpha-pad the plane axis to a fixed K, as the JAX package feeds
    its metrics (``mmlf_tpu.data.pipeline.pad_mpi``)."""
    if mpi.shape[0] >= k:
        return mpi[:k]
    pad = np.zeros((k - mpi.shape[0],) + mpi.shape[1:], mpi.dtype)
    return np.concatenate([mpi, pad], 0)


class HCI4D:
    """Dataset over a directory of scene subdirectories: ``__getitem__``
    gives the 9-tuple, ``save_batch`` writes the artifact tree.

    ``cache=True`` loads every scene once (``cache_scenes``) into
    ``self.data``; ``length`` > 0 gives the dataset that virtual length
    (indices wrap around the scenes)."""

    def __init__(self, root: str, nviews=(9, 9),
                 transform: Optional[Callable] = None, cache: bool = False,
                 length: int = 0, texture_mask: bool = True):
        self.root = root
        self.name = os.path.basename(root)
        entries = sorted((f.name, f.path) for f in os.scandir(root)
                         if f.is_dir())
        self.scenes_names = [n for n, _ in entries]
        self.scenes = [p for _, p in entries]
        self.nviews = nviews
        self.transform = transform
        self.length = length
        self.texture_mask = texture_mask

        self.cache = cache
        self.data = []
        if cache:
            self.cache_scenes()

    def cache_scenes(self):
        print(f'Caching dataset "{self.name}"...')
        self.data = [load_scene(s, self.nviews, i, self.texture_mask)
                     for i, s in enumerate(self.scenes)]

    def __len__(self):
        return self.length if self.length else len(self.scenes)

    def __getitem__(self, index: int):
        index = index % len(self.scenes)
        if self.cache:
            data = self.data[index]
        else:
            data = load_scene(self.scenes[index], self.nviews, index,
                              self.texture_mask)
        if self.transform:
            data = self.transform(copy.deepcopy(data))
        return data

    def save_batch(self, path: str, index, result=None, uncert=None,
                   runtime=None, gmm=None, nll=None, posterior=None,
                   sample=None):
        """Write per-scene artifacts + the HCI-benchmark submission layout.

        Per scene ``scenes/<name>/{view_*.png, center.png, gt.png,
        diff.png, gt.pfm, result.{pfm,png}, uncert.{pfm,png}, gmm.npy,
        nll.npy, posterior.npy}`` plus ``ours/disp_maps/<name>.pfm`` and
        ``ours/runtimes/<name>.txt``.

        ``result``/``uncert`` are ``(b, H, W)``; ``gmm`` is
        ``(2, K, b, H, W)``; ``nll``/``posterior`` are ``(b, S, H, W)``
        (bin-first, the reference's on-disk layout).  All numpy.
        ``sample``, for a one-scene ``index``, is the 9-tuple ``self[i]``
        gave the caller: its views, centre and gt are written as they are,
        and the scene is not loaded again.

        The files are encoded and written side by side on a pool of
        threads (PIL's encoder and the writes release the GIL), the
        largest first.  The call returns once every file is closed, and
        raises the first error of any of them.
        """
        scenes_dir = os.path.join(path, 'scenes')
        disp_maps = os.path.join(path, 'ours', 'disp_maps')
        runtimes = os.path.join(path, 'ours', 'runtimes')
        for d in (scenes_dir, disp_maps, runtimes):
            os.makedirs(d, exist_ok=True)

        index = np.asarray(index).reshape(-1)
        if sample is not None and index.shape[0] != 1:
            raise ValueError(f'a handed sample is one scene; the index '
                             f'names {index.shape[0]}')
        jobs = []    # (bytes in, writer, file, what it writes)

        def write(fn, file, data):
            jobs.append((getattr(data, 'nbytes', 0), fn, file, data))

        for arr_i, i in enumerate(index.tolist()):
            i = int(i)
            scene = self.scenes_names[i]
            scene_dir = os.path.join(scenes_dir, scene)
            os.makedirs(scene_dir, exist_ok=True)

            h_views, v_views, i_views, d_views, center, gt = \
                (self[i] if sample is None else sample)[:6]

            for tag, stack in zip('hvid', (h_views, v_views, i_views,
                                           d_views)):
                for j, view in enumerate(stack):
                    write(save_img,
                          os.path.join(scene_dir, f'view_{tag}_{j}.png'), view)
            write(save_img, os.path.join(scene_dir, 'center.png'), center)
            write(save_img, os.path.join(scene_dir, 'gt.png'), gt)
            if result is not None:
                write(save_img, os.path.join(scene_dir, 'diff.png'),
                      np.abs(gt - result[arr_i]))

            write(pfm.save, os.path.join(scene_dir, 'gt.pfm'),
                  np.flip(gt, 0).copy())

            if result is not None:
                res = np.flip(result[arr_i].astype(np.float32), 0).copy()
                write(pfm.save, os.path.join(scene_dir, 'result.pfm'), res)
                write(pfm.save, os.path.join(disp_maps, f'{scene}.pfm'), res)

                lo, hi = float(np.min(gt)), float(np.max(gt))
                img = (result[arr_i] - lo) / (hi - lo) if hi > lo \
                    else np.zeros_like(result[arr_i])
                write(save_img, os.path.join(scene_dir, 'result.png'),
                      np.clip(img, 0.0, 1.0))

            if uncert is not None:
                unc = np.flip(uncert[arr_i].astype(np.float32), 0).copy()
                write(pfm.save, os.path.join(scene_dir, 'uncert.pfm'), unc)
                write(save_img, os.path.join(scene_dir, 'uncert.png'),
                      uncert[arr_i])

            if gmm is not None:
                write(_save_npy, os.path.join(scene_dir, 'gmm.npy'),
                      gmm[:, :, arr_i])
            if nll is not None:
                write(_save_npy, os.path.join(scene_dir, 'nll.npy'),
                      nll[arr_i])
            if posterior is not None:
                write(_save_npy, os.path.join(scene_dir, 'posterior.npy'),
                      posterior[arr_i])

            if runtime is not None:
                per_item = float(runtime) / float(index.shape[0])
                write(_write_text, os.path.join(runtimes, f'{scene}.txt'),
                      str(per_item))

        jobs.sort(key=lambda job: -job[0])
        workers = max(1, min(len(jobs), len(os.sched_getaffinity(0))))
        # leaving the block joins every thread, whatever a job raised
        with ThreadPoolExecutor(workers) as pool:
            futures = [pool.submit(fn, file, data)
                       for _, fn, file, data in jobs]
        for future in futures:
            future.result()


def _save_npy(file: str, arr: np.ndarray) -> None:
    """``np.save`` of a strided array from a C-contiguous copy: the same
    bytes, without numpy's element-by-element path for a strided one (a
    Fortran-ordered array is saved as it is, which is what ``np.save``
    writes for it)."""
    if not arr.flags.f_contiguous:
        arr = np.ascontiguousarray(arr)
    np.save(file, arr)


def _write_text(file: str, text: str) -> None:
    with open(file, 'w') as f:
        f.write(text)
