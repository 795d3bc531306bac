#!/usr/bin/env python3
"""Where the time of K3's bfloat16 conv GEMMs goes, on one CUDA card.

    python3 k3_variants.py            # every variant below
    python3 k3_variants.py base nomath

Builds text variants of ``mmlf_tpu_torch/csrc/conv_block.cu`` (one nvcc
each, started together, into ``build/k3_variants/``) and times the bf16
280→280 block of the recipe (B 64, 96², relu_in and affine_in) forward and
backward with each, in two rounds.  Each variant leaves one piece of the
span producer (``produce_spans``, ``SpanLoader``) out, so its time against
``base`` is what that piece costs the block.  Every variant but ``base``
computes wrong values: they exist to be timed, and the script prints only
how far each one's y2 lies from ``base``'s.

- ``base``: the kernel as it is;
- ``nofence``: no proxy fence before the producers publish a stage;
- ``nowait``: the producers do not wait for a slot's bulk copies;
- ``nobarrier``: no producers' barrier at the top of a stage;
- ``nomath``: no input stage (the taps go to the tile as they are);
- ``notransform``: the producers wait for each stage's copies and
  publish it without writing the A tile: what is left is the consumers'
  and the epilogue's time.

Imports nothing of JAX or of mmlf_tpu.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
SRC_PATH = os.path.join(REPO, 'mmlf_tpu_torch', 'csrc', 'conv_block.cu')
OUT = os.path.join(REPO, 'build', 'k3_variants')


def variants(src: str) -> dict:
    """``{name: source}``; each substitution must find its text."""
    start = src.index('produce_spans(const SpanLoader<C>& ld')
    prod = src[start:src.index('\n}\n', start)]

    def in_producer(old: str, new: str) -> str:
        assert prod.count(old) == 1, old
        return src.replace(prod, prod.replace(old, new))

    def sub(old: str, new: str) -> str:
        assert src.count(old) == 1, old
        return src.replace(old, new)

    return {
        'base': src,
        'nofence': in_producer('    fence_proxy_async();\n', ''),
        'nowait': sub('    mbar_wait(sm.full + slot, (kt / STAGES) & 1);\n',
                      ''),
        'nobarrier': in_producer('    bar_sync(BAR_PRODUCERS, THREADS);\n',
                                 ''),
        'nomath': sub('        if ((flags & IN_AFFINE) && ci < cin) {',
                      '        if (false) {'),
        'notransform': in_producer(
            '    ld.transform(kt, kt % STAGES, buf);\n',
            '    mbar_wait(ld.sm.full + kt % STAGES, (kt / STAGES) & 1);\n'),
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('k3_variants: CUDA is not available', file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from mmlf_tpu_torch.ops.kernels import build
    from mmlf_tpu_torch.ops.kernels import conv_block as C
    from mmlf_tpu_torch.utils.device import resolve_device
    resolve_device('cuda')

    all_variants = variants(open(SRC_PATH).read())
    names = sys.argv[1:] or list(all_variants)
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name in names:
        cu = os.path.join(OUT, f'{name}.cu')
        with open(cu, 'w') as f:
            f.write(all_variants[name])
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, '-o',
             os.path.join(OUT, f'{name}.so'), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f'k3_variants: nvcc failed for {name}:\n{log}',
                  file=sys.stderr)
            return 1
        libs[name] = ctypes.CDLL(os.path.join(OUT, f'{name}.so'))

    print(f'card: {cs.smi("name,power.limit")}', flush=True)
    x, si, ti, w1, b1, w2, b2, dy2, dps, dpss = cs.k3_inputs(
        64, 96, 96, 280, 280, seed=1)
    x, dy2 = x.bfloat16(), dy2.bfloat16()
    fa = (x, si, ti, w1, b1, w2, b2, True, True)
    ref = None
    for rnd in range(2):
        for name, lib in libs.items():
            build.load = lambda _, lib=lib: lib       # this variant's K3
            y2 = C.fused_double_conv_fwd(*fa)[0]
            torch.cuda.synchronize()
            if ref is None:
                ref = y2.float()
            diff = float((y2.float() - ref).abs().max())
            ms_f = cs.cuda_ms(lambda: C.fused_double_conv_fwd(*fa), reps=3)
            ba = (x, si, ti, w1, b1, w2, ref.bfloat16(), dy2, dps, dpss,
                  True, True)
            ms_b = cs.cuda_ms(lambda: C.fused_double_conv_bwd(*ba), reps=3)
            print(f'round {rnd} {name}: bf16 280->280 B=64 96x96 fwd '
                  f'{ms_f:.3f} ms, bwd {ms_b:.3f} ms; max |y2 - base y2| '
                  f'{diff:.3e}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
