"""The probe scripts' TPU kernels on the card: ``block_probe`` (the fused
double-conv block of ``scripts/pallas_block_probe.py``, a configuration of
kernel K3) and ``gather_probe`` (the window copies of
``scripts/gather_probe3.py`` and ``gather_probe4.py``, configurations of
kernel K1)."""


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up
    (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
