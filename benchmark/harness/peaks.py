"""Peaks of one NVIDIA H100 SXM and the counts of operations and bytes of
the port's kernels; a net's own counts are in its module under ``nets/``.

Frozen copy of ``chip_smoke.py``'s ``PEAK_*`` constants,
``window_gather_bound``, ``posterior_bound`` and ``k3_bound``;
``window_gather_bound`` writes out K1's ``AUX_CH`` and ``MPI_CH``
(``ops/kernels/window_gather.py``) instead of importing them.
"""

# NVIDIA's data sheet, SXM part, dense rates: HBM bytes/s, fp32 FLOP/s
# outside the tensor cores, TF32 and bf16 FLOP/s of the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
# an fp32-accurate product in 3xTF32 (hi*hi' + hi*lo' + lo*hi') costs three
# TF32 products
PEAK_3XTF32 = PEAK_TF32 / 3

# K1's packed pyramid: per-pixel aux words (gt, mask, padding) and MPI
# words (12 planes x 5, padded)
AUX_CH = 8
MPI_CH = 64


def window_gather_bound(b: int, win: int, ci: int, with_mpi: bool,
                        img_bytes: int = 4):
    """Least time for K1: every selected window byte read once and written
    once, over the HBM rate (a copy has no arithmetic); the image field has
    ``img_bytes`` an element (2 under --cache_bf16), aux and mpi 4.
    Returns ``(ms, bytes)``."""
    per_pixel = img_bytes * ci + 4 * (AUX_CH + (MPI_CH if with_mpi else 0))
    n_bytes = 2 * b * win * win * per_pixel
    return n_bytes / PEAK_BYTES * 1e3, n_bytes


def posterior_bound(k: int, p: int, kb: int):
    """Least time for the mixture posterior on the card: bytes (two (K, P)
    reads, the bins, one (P, Kb) write) over HBM rate vs fp32 operations
    (per term: sub, mul, exp, fma = 5; per member and pixel: rcp and two
    muls) over the fp32 peak.  Returns ``(ms, 'bytes' | 'operations')``."""
    n_bytes = 4 * (2 * k * p + kb + p * kb)
    n_ops = 5 * k * kb * p + 3 * k * p
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_FP32
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


def k3_bound(b, h, w, cin, cout, peak=PEAK_3XTF32, eb=4):
    """Least times of K3 on the card, ``((fwd ms, by), (bwd ms, by))``.
    Operations: the forward's two k=2 convs (to (H+1)x(W+1) and HxW); the
    backward's five (y1 again, two dgrads, two wgrads), 2 FLOP per
    multiply-add at ``peak``.  Bytes: each input read once, each output
    written once (fwd: x, y2; bwd: x, y2, dy2, dx; plus weights), ``eb``
    bytes an activation or weight element (2 for bf16), 4 a vector
    element."""
    p1, p0 = b * (h + 1) * (w + 1), b * h * w
    c1, c2 = 2 * 4 * cin * cout, 2 * 4 * cout * cout
    ops_f = p1 * c1 + p0 * c2
    ops_b = 2 * p1 * c1 + p1 * c2 + p0 * c1 + p0 * c2
    act_in, act_out = b * cin * h * w, b * cout * h * w
    weights, vectors = 4 * cin * cout + 4 * cout * cout, 2 * cin + 2 * cout
    by_f = eb * (act_in + act_out + weights) + 4 * (vectors + 2 * cout)
    by_b = eb * (2 * act_in + 2 * act_out + 2 * weights) + \
        4 * (2 * vectors + 2 * cout)

    def bound(ops, n_bytes):
        t_ops, t_bytes = ops / peak, n_bytes / PEAK_BYTES
        return (max(t_ops, t_bytes) * 1e3,
                'operations' if t_ops >= t_bytes else 'bytes')
    return bound(ops_f, by_f), bound(ops_b, by_b)


def k3_step_bound_ms(blocks, b: int, ps: int, accum: int, peak: float,
                     eb: int) -> float:
    """Least time of K3 over one train step: forward and backward of every
    block of ``blocks`` (``[((cin, cout), count)]``, a net's
    ``k3_blocks``) at microbatch ``b`` and ``ps``², times ``accum``
    microbatches."""
    total = 0.0
    for (cin, cout), n in blocks:
        (fwd, _), (bwd, _) = k3_bound(b, ps, ps, cin, cout, peak, eb)
        total += n * (fwd + bwd)
    return total * accum
