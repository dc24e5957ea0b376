"""Fixed weights for the port's parity tests: a JAX param tree (from any of
the reference's inits) with every drawn leaf redrawn from numpy.

The reference's inits salt their keys with Python's per-process string
hash (``repro.utils.fold_key``), so the same ``jax.random.key`` gives other
weights in every process, and under pytest-xdist in every worker. A
tolerance checked on one draw can then fail on another. Redrawn from a
numpy seed, the weights are the same in every run.

Rules, by leaf:
  * two or more dims (dense weights, embeddings, conv taps, and the stacked
    per-period copies of 1-D leaves): N(0, std^2) with the reference's
    std, 0.02 under "embed", else ``shape[-2] ** -0.5`` (the d_in scale of
    ``init_dense``; conv taps ``conv_width ** -0.5``);
  * one dim or fewer: kept (norm scales, biases);
  * mamba's ``A_log`` (log 1..N) and ``D_skip`` (ones) keep their constant
    init whatever their rank; ``dt_bias`` is redrawn from the reference's
    distribution, softplus^-1 of a log-uniform dt in [1e-3, 1e-1], f32;
  * the RG-LRU's ``Lambda`` is redrawn, whatever its rank, from the
    reference's distribution, softplus^-1(-log(u) / 8) for u uniform in
    [0.9, 0.999], f32.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_CONSTANT = ("A_log", "D_skip")


def _name(path):
    last = path[-1]
    return getattr(last, "key", getattr(last, "name", str(last)))


def dt_bias_draw(rng, shape):
    """softplus^-1 of dt ~ log-uniform [1e-3, 1e-1], as ``init_mamba``."""
    lo, hi = np.log(1e-3), np.log(1e-1)
    dt = np.exp(rng.uniform(size=shape) * (hi - lo) + lo).astype(np.float32)
    return (dt + np.log(-np.expm1(-dt))).astype(np.float32)


def lambda_draw(rng, shape):
    """softplus^-1(-log(u) / 8), u ~ U(0.9, 0.999), as ``init_rglru``."""
    u = rng.uniform(0.9, 0.999, size=shape)
    return np.log(np.expm1(-np.log(u) / 8.0)).astype(np.float32)


def seeded(tree, seed=0):
    """``tree`` with its drawn leaves redrawn from ``seed`` (rules above),
    each in its own dtype."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        name = _name(path)
        if name in _CONSTANT:
            return jnp.asarray(a)
        if name == "dt_bias":
            return jnp.asarray(dt_bias_draw(rng, a.shape))
        if name == "Lambda":
            return jnp.asarray(lambda_draw(rng, a.shape))
        if a.ndim < 2:
            return jnp.asarray(a)
        std = 0.02 if "embed" in jax.tree_util.keystr(path) \
            else a.shape[-2] ** -0.5
        return jnp.asarray((rng.standard_normal(a.shape) * std)
                           .astype(np.float32)).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def seeded_params(jcfg, seed=0):
    """The reference's full param tree for ``jcfg``, redrawn from ``seed``."""
    from repro.models import build_model
    return seeded(build_model(jcfg).init(jax.random.key(0)), seed)
