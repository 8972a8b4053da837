from .optimizers import (
    adam_init, adam_update, sgd_update, global_norm, clip_by_global_norm,
    clip_scale_by_global_norm, clip_scale_from_norm, OptConfig,
    make_optimizer, make_delayed_apply,
    reference_delayed_apply, fused_delayed_apply, fused_adam_update,
    fused_sgd_update, resolve_update_impl, UPDATE_IMPLS,
)
from .pool import (LeafSlot, PoolLayout, build_layout, init_pools,
                   pool_tree, pool_zeros, pooled_delayed_apply,
                   pooled_global_norm, pooled_update, unpool_tree)

__all__ = ["adam_init", "adam_update", "sgd_update", "global_norm",
           "clip_by_global_norm", "clip_scale_by_global_norm",
           "clip_scale_from_norm", "OptConfig",
           "make_optimizer", "make_delayed_apply", "reference_delayed_apply",
           "fused_delayed_apply", "fused_adam_update", "fused_sgd_update",
           "resolve_update_impl", "UPDATE_IMPLS",
           "LeafSlot", "PoolLayout", "build_layout", "init_pools",
           "pool_tree", "pool_zeros", "pooled_delayed_apply",
           "pooled_global_norm", "pooled_update", "unpool_tree"]
