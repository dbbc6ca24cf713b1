"""Parameter paths in the JAX package's ``/``-joined form (port of
``chambers_tpu/utils/pytree.py``), the format that the optimizers' decay
masks, ``Trainer(trainable=)`` and LoRA's targets match regexes against."""

from torch import nn

from chambers_tpu_torch.models.backbones.convert import jax_path


def param_paths(params):
    """The ``/``-joined paths of a module's parameters (registration
    order, as ``named_parameters``), or of the leaves of a nested dict
    (keys sorted at every level, the order ``jax.tree_util`` flattens a
    dict in)."""
    if isinstance(params, nn.Module):
        return [jax_path(name) for name, _ in params.named_parameters()]
    paths = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], prefix + [str(key)])
        elif isinstance(node, (list, tuple)):
            for i, value in enumerate(node):
                walk(value, prefix + [str(i)])
        else:
            paths.append("/".join(prefix))

    walk(params, [])
    return paths
