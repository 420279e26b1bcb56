"""Sharding rules (``specs``) and the model on DTensor parameters
(``dtensor``).  The rules' names are loaded on first use: the model code
imports ``sharding.dtensor``, and ``specs`` imports the model."""

__all__ = ["batch_spec", "cache_specs", "needs_fsdp", "param_specs",
           "placements", "spec_tree_to_shardings"]


def __getattr__(name):
    if name in __all__:
        from repro_torch.sharding import specs
        return getattr(specs, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
