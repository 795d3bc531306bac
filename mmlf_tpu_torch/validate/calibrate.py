"""ESE logvar-calibration guard + post-hoc per-member recalibration (numpy).

The shift ensemble's min-logvar member selection silently breaks when the
UPR logvar head is miscalibrated, and nothing in the UPR metrics shows it,
so the validate CLI checks calibration whenever it evaluates an ensemble:

* **rank correlation** — per-pixel Spearman correlation between member
  logvar and member |error| across the shift grid.  Selection only works
  if logvar orders members the way error does.
* **bare-vs-ESE MSE** — the zero-shift member IS the bare UPR forward, so
  the guard checks that ensembling did not hurt without an extra forward.

``fit_member_offsets`` is the post-hoc repair (``--val_recalibrate``): a
per-member scalar offset ``c_k = mean(logvar_k) - log(mean |err_k|)`` fit
on calibration scenes, subtracted from every member's logvar.

A copy of ``mmlf_tpu.validate.calibrate``; the thresholds are that
module's.
"""

from __future__ import annotations

import numpy as np

# healthy checkpoints score about +0.8, broken ones +0.29 and below
RANK_CORR_MIN = 0.5
# ESE may not be worse than the bare model beyond float/selection noise
ESE_MSE_TOL = 1.05


def member_rank_corr(logvars: np.ndarray, errs: np.ndarray) -> np.ndarray:
    """Per-pixel Spearman rank correlation along the member axis (axis 0).

    :param logvars: ``(K, H, W)``
    :param errs: ``(K, H, W)``
    :returns: ``(H, W)`` correlation map in [-1, 1]
    """
    def ranks(x):
        order = np.argsort(x, axis=0)
        rk = np.empty(order.shape, np.float32)
        member_idx = np.arange(x.shape[0], dtype=np.float32).reshape(
            (-1,) + (1,) * (x.ndim - 1))
        np.put_along_axis(rk, order, np.broadcast_to(member_idx, x.shape),
                          axis=0)
        return rk
    ra, rb = ranks(logvars), ranks(errs)
    ra -= ra.mean(0)
    rb -= rb.mean(0)
    denom = np.sqrt((ra ** 2).sum(0) * (rb ** 2).sum(0)) + 1e-9
    return (ra * rb).sum(0) / denom


def scene_calibration(shifts: np.ndarray, means: np.ndarray,
                      logvars: np.ndarray, gt: np.ndarray,
                      mask: np.ndarray) -> dict:
    """Per-scene calibration statistics from the member stacks.

    :param shifts: ``(K,)`` member shift grid
    :param means: ``(K, H, W)`` member means (already ``+ shift_k``)
    :param logvars: ``(K, H, W)`` member logvars (as selected on)
    :param gt: ``(H, W)``
    :param mask: ``(H, W)`` bool — pixels the metrics count
    """
    errs = np.abs(means - gt[None])
    corr = float(member_rank_corr(logvars, errs)[mask].mean())

    bare_mse = None
    k0 = int(np.argmin(np.abs(shifts)))
    # "zero" up to the float32 accumulation error of the arange grid (the
    # default grid's member 35 is -3.3e-6); 1e-3 is far below any step
    if abs(float(shifts[k0])) < 1e-3:
        bare_mse = float(((means[k0] - gt) ** 2)[mask].mean())
    return {'rank_corr': corr, 'bare_mse': bare_mse}


def calibration_report(per_scene: list[dict], ese_mse: float) -> dict:
    """Aggregate per-scene stats into the guard verdict: ``rank_corr``,
    ``bare_mse``, ``ese_mse``, ``calibrated`` and ``warnings``."""
    corr = float(np.mean([s['rank_corr'] for s in per_scene]))
    bares = [s['bare_mse'] for s in per_scene if s['bare_mse'] is not None]
    bare_mse = float(np.mean(bares)) if bares else None

    warnings = []
    if corr < RANK_CORR_MIN:
        warnings.append(
            f'ESE CALIBRATION WARNING: member logvar/|err| rank '
            f'correlation {corr:+.3f} < {RANK_CORR_MIN:+.2f} — the logvar '
            f'head does not order ensemble members by their error, so '
            f'min-logvar selection is unreliable (healthy checkpoints '
            f'score ~+0.8).  Do not ship this checkpoint\'s ensemble '
            f'without recalibration (--val_recalibrate) or retraining '
            f'(--train_logvar_anchor).')
    if bare_mse is not None and ese_mse > bare_mse * ESE_MSE_TOL:
        warnings.append(
            f'ESE CALIBRATION WARNING: ensemble MSE {ese_mse:.5f} exceeds '
            f'the bare (zero-shift) model\'s {bare_mse:.5f} — member '
            f'selection is actively harmful on this checkpoint.')
    return {'rank_corr': corr, 'bare_mse': bare_mse, 'ese_mse': ese_mse,
            'calibrated': not warnings, 'warnings': warnings}


def fit_member_offsets(scene_stats: list[tuple], eps: float = 1e-6
                       ) -> np.ndarray:
    """Fit per-member logvar offsets on calibration scenes.

    :param scene_stats: list of ``(means, logvars, gt, mask)`` tuples with
        shapes as in :func:`scene_calibration`
    :returns: ``(K,)`` offsets ``c_k``; selection and posteriors use
        ``logvar_k - c_k``
    """
    lv_sum = err_sum = None
    n_px = 0
    for means, logvars, gt, mask in scene_stats:
        errs = np.abs(means - gt[None])[:, mask]      # (K, n)
        lvs = logvars[:, mask]
        if lv_sum is None:
            lv_sum = lvs.sum(1)
            err_sum = errs.sum(1)
        else:
            lv_sum += lvs.sum(1)
            err_sum += errs.sum(1)
        n_px += lvs.shape[1]
    lv_mean = lv_sum / max(n_px, 1)
    err_mean = err_sum / max(n_px, 1)
    return (lv_mean - np.log(np.maximum(err_mean, eps))).astype(np.float32)
