"""The port's models; ``build_model`` picks the one a config asks for."""


def build_model(cfg):
    """The INN for ``model_inn``, else ``FeedForward`` (which raises for
    ``model_invertible``)."""
    if cfg.model_inn:
        from .inn import INN
        return INN.from_config(cfg)
    from .feed_forward import FeedForward
    return FeedForward.from_config(cfg)


def init_model_(model, seed: int = 0):
    """The model's seeded initial weights, in place (``init_inn_`` or
    ``init_default_``)."""
    from .inn import INN, init_inn_
    from .feed_forward import init_default_
    return (init_inn_ if isinstance(model, INN) else init_default_)(model,
                                                                    seed)
