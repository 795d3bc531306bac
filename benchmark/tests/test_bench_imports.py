"""No module the harness or its reference loads is ``jax`` or the JAX
package ``mmlf_tpu`` (top-level names compared whole: the port's name
begins with ``mmlf_tpu``), and the reference loads nothing of the port."""

import json
import subprocess
import sys
import textwrap

import run

PROBE = textwrap.dedent('''
    import json, sys
    sys.path[:0] = [{root!r}, {bench!r}]
    {body}
    print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
''')


def loaded(body: str) -> set:
    code = PROBE.format(root=run.ROOT, bench=run.BENCH_DIR, body=body)
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=600, check=True)
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_jax_or_the_port():
    top = loaded('from harness import check, nets, reference, synth, '
                 'weights, peaks, trace; nets.load({})')
    assert not top & {'jax', 'jaxlib', 'flax', 'mmlf_tpu',
                      'mmlf_tpu_torch'}


def test_a_tiny_run_loads_nothing_of_jax():
    top = loaded(textwrap.dedent('''
        import run
        from harness import drive
        bench, cell, config, traffic, readers = run.resolve('upr_fp32.ese')
        config = dict(config, port_config={**config['port_config'],
                      'model_chs': 4, 'model_in_blocks': 1,
                      'model_out_blocks': 2})
        traffic = dict(traffic, scenes=1, scene_size=64)
        drive.run_cell(cell, config, traffic, 3, 0.1, False, 'cpu')
        bench, cell, config, traffic, readers = run.resolve(
            'upr_bf16_trunk.train')
        config = dict(config, port_config={**config['port_config'],
                      'model_chs': 4, 'model_in_blocks': 1,
                      'model_out_blocks': 2, 'train_bs': 4,
                      'train_accum': 2, 'train_ps': 32,
                      'train_max_downscale': 1})
        traffic = dict(traffic, scenes=1, scene_size=64)
        drive.run_cell(cell, config, traffic, 3, 0.1, False, 'cpu')
        assert not run.forbidden_modules()
    '''))
    assert 'mmlf_tpu_torch' in top
    assert not top & set(run.FORBIDDEN)
