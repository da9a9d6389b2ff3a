"""Model registry (the counterpart of ``dlq_tpu.models.registry``): name ->
builder returning ``(config, init, forward)``, under the reference's names.
The port's ``init`` takes an integer seed (a numpy generator's) where the
reference's takes a PRNG key."""

_REGISTRY = {}


def register(name):
    def deco(builder):
        _REGISTRY[name] = builder
        return builder

    return deco


def get_model(name: str, **kw):
    """Build (config, init_fn, forward_fn) by registered name."""
    from dlq_tpu_torch.models import lenet, mlp, mobilenetv2, resnet, vit  # noqa: F401

    return _REGISTRY[name](**kw)


def available():
    from dlq_tpu_torch.models import lenet, mlp, mobilenetv2, resnet, vit  # noqa: F401

    return sorted(_REGISTRY)
