from repro_torch.sharding.rules import (  # noqa: F401
    Axes, make_axes, param_shardings, batch_shardings, cache_shardings,
    opt_shardings, state_shardings, replicated, fit_spec, local_shard,
    gather)
