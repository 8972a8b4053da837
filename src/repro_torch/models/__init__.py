from .specs import Spec, init_tree, count_params
from .model import (
    param_specs,
    init_params,
    n_params,
    forward_logits,
    cache_specs,
    prefill,
    init_cache,
    decode_step,
    loss_fn,
    batch_specs,
)
from .convert import (params_from_numpy, params_to_numpy, state_from_numpy,
                      state_to_numpy)
from . import layers

__all__ = [
    "Spec", "init_tree", "count_params",
    "param_specs", "init_params", "n_params",
    "forward_logits", "cache_specs", "prefill", "init_cache", "decode_step",
    "loss_fn", "batch_specs",
    "params_from_numpy", "params_to_numpy", "state_from_numpy",
    "state_to_numpy", "layers",
]
