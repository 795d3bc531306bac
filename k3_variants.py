#!/usr/bin/env python3
"""Where the time of K3's bfloat16 GEMMs goes, on one CUDA card.

    python3 k3_variants.py            # every variant below
    python3 k3_variants.py base nomath wg_notransform
    python3 k3_variants.py --parent OLD/conv_block.cu base parent

Builds text variants of ``mmlf_tpu_torch/csrc/conv_block.cu`` (one nvcc
each, started together, into ``build/k3_variants/``) and times the bf16
280→280 block of the recipe (B 64, 96², relu_in and affine_in) forward and
backward with each, in two rounds, with the backward split by the
profiler into its conv GEMMs (conv2x2_kernel), its weight gradients
(wgrad_kernel) and the rest.  Each variant leaves one piece of a span
producer out, so its time against ``base`` is what that piece costs the
block.  Every variant but ``base`` (and ``parent``) computes wrong values:
they exist to be timed, and the script prints only how far each one's y2
lies from ``base``'s.

The conv GEMMs' producer (``produce_spans``, ``SpanLoader``):
- ``nofence``: no proxy fence before the producers publish a stage;
- ``nowait``: the producers do not wait for a slot's bulk copies;
- ``nobarrier``: no producers' barrier at the top of a stage;
- ``nomath``: no input stage (the taps go to the tile as they are);
- ``notransform``: the producers wait for each stage's copies and
  publish it without writing the A tile.

The weight gradients' producer (``produce_wgrad_spans``,
``WgradSpanLoader``):
- ``wg_nowait``: as above;
- ``wg_nobarrier``: no producers' barrier at the first stage of a group;
- ``wg_notransform``: the producers wait for each stage's copies and
  publish it without writing the A and B tiles: what is left of the
  wgrads is the consumers', the copies' and the epilogue's time;
- ``wg_nocopy``: no bulk copy is issued (and no byte announced): the
  transform reads whatever the ring holds.

Both GEMMs' consumer (``consume``):
- ``noproducts``: the consumers wait for each stage and free it with no
  products and no flush into fp32 registers: the time left is the
  producers', the copies' and the epilogue's, the most a faster consumer
  can give.

``--parent FILE`` adds the variant ``parent``, another version of the
source (say, the parent commit's), driven by this tree's wrapper (the C
interface must match).  For it the script also runs the backward of every
recipe block with both libraries on the same inputs and says whether
each output is equal to ``base``'s bit for bit.

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
BWD_NAMES = ('dx', 'dsi', 'dti', 'dw1', 'db1', 'dw2', 'db2')


def variants(src: str) -> dict:
    """``{name: source}``; each substitution must find its text once in
    the function or struct it names."""

    def body(start: str, end: str) -> str:
        a = src.index(start)
        return src[a:src.index(end, a)]

    def within(start: str, end: str, old: str, new: str) -> str:
        part = body(start, end)
        assert part.count(old) == 1, old
        return src.replace(part, part.replace(old, new))

    prod = ('produce_spans(const SpanLoader<C>& ld', '\n}\n')
    span = ('struct SpanLoader {', '\n};\n')
    wprod = ('produce_wgrad_spans(WgradSpanLoader<C>& ld', '\n}\n')
    wspan = ('struct WgradSpanLoader {', '\n};\n')
    cons = ('void consume(const OpSmem<C>& sm', '\n}\n')
    wait = '    mbar_wait(sm.full + slot, (kt / STAGES) & 1);\n'
    barrier = '    bar_sync(BAR_PRODUCERS, THREADS);\n'
    transform = '    ld.transform(kt, kt % STAGES, buf);\n'
    wait_only = '    mbar_wait(ld.sm.full + kt % STAGES, (kt / STAGES) & 1);\n'
    wg_wait = '    mbar_wait(sm.full + half, kt / D >> 1 & 1);\n'
    wg_transform = '    ld.transform(kt, buf);\n'
    wg_wait_only = ('    mbar_wait(ld.sm.full + (kt / D & 1), '
                    'kt / D >> 1 & 1);\n')

    def noproducts() -> str:
        part = body(*cons)
        calls = [line for line in part.splitlines(True)
                 if 'stage_products<C>(' in line]
        assert len(calls) == 1, calls
        # a flush of each stage into fp32 registers, where there is one
        new = part.replace(calls[0], '').replace(
            'acc[mi][i] += t[mi][i];', ';')
        return src.replace(part, new)

    return {
        'base': src,
        'nofence': within(*prod, '    fence_proxy_async();\n', ''),
        'nowait': within(*span, wait, ''),
        'nobarrier': within(*prod, barrier, ''),
        'nomath': within(*span,
                         '        if ((flags & IN_AFFINE) && ci < cin) {',
                         '        if (false) {'),
        'notransform': within(*prod, transform, wait_only),
        'wg_nowait': within(*wspan, wg_wait, ''),
        'wg_nobarrier': within(*wprod, '  ' + barrier, ''),
        'wg_notransform': within(*wprod, wg_transform, wg_wait_only),
        'wg_nocopy': within(*wspan, '    } else {\n      return;\n    }\n',
                            '    }\n    return;\n'),
        'noproducts': noproducts(),
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

    args = sys.argv[1:]
    all_variants = variants(open(SRC_PATH).read())
    if '--parent' in args:
        i = args.index('--parent')
        with open(args[i + 1]) as f:
            all_variants['parent'] = f.read()
        del args[i:i + 2]
    names = args or list(all_variants)
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

    def use(lib):
        build.load = lambda _, lib=lib: lib        # this variant's K3

    print(f'card: {cs.smi("name,power.limit")}', flush=True)
    if 'parent' in libs and 'base' in libs:
        for (cin, cout, relu_in, affine_in), _ in cs.K3_BLOCKS:
            x, si, ti, w1, b1, w2, b2, dy2, dps, dpss = cs.k3_inputs(
                64, 96, 96, cin, cout, seed=cin + cout)
            x, dy2 = x.bfloat16(), dy2.bfloat16()
            use(libs['base'])
            y2 = C.fused_double_conv_fwd(x, si, ti, w1, b1, w2, b2, relu_in,
                                         affine_in)[0]
            ba = (x, si, ti, w1, b1, w2, y2, dy2, dps, dpss, relu_in,
                  affine_in)
            outs = {}
            for name in ('base', 'parent'):
                use(libs[name])
                outs[name] = C.fused_double_conv_bwd(*ba)
            torch.cuda.synchronize()
            same = [n for n, a, b in zip(BWD_NAMES, outs['base'],
                                         outs['parent']) if torch.equal(a, b)]
            diff = [n for n in BWD_NAMES if n not in same]
            print(f'bit for bit, bf16 bwd {cin}->{cout} B=64 96x96, base '
                  f'against parent: equal {", ".join(same) or "none"}; '
                  f'differ {", ".join(diff) or "none"}', flush=True)

    x, si, ti, w1, b1, w2, b2, dy2, dps, dpss = cs.k3_inputs(
        64, 96, 96, 280, 280, seed=1)
    x, dy2 = x.bfloat16(), dy2.bfloat16()
    fa = (x, si, ti, w1, b1, w2, b2, True, True)
    ref = None
    for rnd in range(2):
        for name, lib in libs.items():
            use(lib)
            y2 = C.fused_double_conv_fwd(*fa)[0]
            torch.cuda.synchronize()
            if ref is None:
                ref = y2.float()
            diff = float((y2.float() - ref).abs().max())
            ms_f = cs.cuda_ms(lambda: C.fused_double_conv_fwd(*fa), reps=3)
            ba = (x, si, ti, w1, b1, w2, ref.bfloat16(), dy2, dps, dpss,
                  True, True)
            ms_b = cs.cuda_ms(lambda: C.fused_double_conv_bwd(*ba), reps=3)
            conv, wgrad, rest = cs.bwd_split(
                cs.profile_rows(C.fused_double_conv_bwd, ba))
            print(f'round {rnd} {name}: bf16 280->280 B=64 96x96 fwd '
                  f'{ms_f:.3f} ms, bwd {ms_b:.3f} ms (profiler: conv GEMMs '
                  f'{conv:.3f}, wgrads {wgrad:.3f}, rest {rest:.3f}); max '
                  f'|y2 - base y2| {diff:.3e}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
