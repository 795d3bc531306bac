"""The port's CUDA kernels: ``build`` compiles and loads them; each other
module wraps one source of ``csrc/`` and counts its launches."""

# every kernel instance: (module, wrapper, count attribute)
COUNTERS = {
    'window_gather': ('window_gather', 'window_gather', 'launches'),
    'window_gather_bf16': ('window_gather', 'window_gather', 'launches_bf16'),
    'window_copy': ('window_gather', 'window_copy', 'launches'),
    'window_copy_ring': ('window_gather', 'window_copy', 'launches_ring'),
    'fused_double_conv_fwd': ('conv_block', 'fused_double_conv_fwd',
                              'launches'),
    'fused_double_conv_bwd': ('conv_block', 'fused_double_conv_bwd',
                              'launches'),
    'fused_double_conv_fwd_bf16': ('conv_block', 'fused_double_conv_fwd',
                                   'launches_bf16'),
    'fused_double_conv_bwd_bf16': ('conv_block', 'fused_double_conv_bwd',
                                   'launches_bf16'),
    'fused_block_fwd': ('conv_block', 'fused_block_fwd', 'launches'),
    'fused_block_fwd_bf16': ('conv_block', 'fused_block_fwd',
                             'launches_bf16'),
    'laplace_mixture_posterior': ('posterior', 'laplace_mixture_posterior',
                                  'launches'),
}


def counters() -> dict:
    """``{name: (wrapper, count attribute)}`` of every kernel instance."""
    import importlib
    return {name: (getattr(importlib.import_module(f'{__name__}.{module}'),
                           fn), attr)
            for name, (module, fn, attr) in COUNTERS.items()}


def launch_counts() -> dict:
    """This process's launches of every kernel instance, by name."""
    return {name: getattr(fn, attr) for name, (fn, attr) in
            counters().items()}
