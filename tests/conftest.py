"""Test fixtures + a gated fallback for optional deps.

``hypothesis`` is optional in this image. When missing, install a minimal
deterministic stand-in into ``sys.modules`` before test modules import it:
``@given`` expands into a fixed sweep of examples drawn from the same
strategy descriptions (integers/floats/lists), so the property tests still
exercise many input shapes — just from a deterministic grid instead of
randomized shrinking search.
"""
from __future__ import annotations

import sys
import types


def _install_hypothesis_shim():
    try:
        import hypothesis  # noqa: F401
        return
    except ImportError:
        pass

    MAX_EXAMPLES = 20

    class _Strategy:
        def __init__(self, gen):
            self._gen = gen  # (i) -> value for example index i

        def example_at(self, i):
            return self._gen(i)

    def integers(lo, hi):
        span = hi - lo + 1

        def gen(i):
            # boundaries first, then a deterministic stride over the range
            if span <= 1:
                return lo
            if i < 4:
                return lo + min(span - 1, (0, span - 1, 1, span - 2)[i])
            return lo + (i * 7919) % span

        return _Strategy(gen)

    def floats(lo, hi, **_kw):
        def gen(i):
            if i == 0:
                return lo
            if i == 1:
                return hi
            frac = ((i * 2654435761) % 1000) / 1000.0
            return lo + (hi - lo) * frac

        return _Strategy(gen)

    def sampled_from(options):
        options = list(options)
        return _Strategy(lambda i: options[i % len(options)])

    def binary(min_size=0, max_size=16):
        def gen(i):
            size = min_size + (i % (max_size - min_size + 1))
            return bytes((i * 31 + j * 7) % 256 for j in range(size))

        return _Strategy(gen)

    def lists(elem, min_size=0, max_size=10):
        def gen(i):
            size = min_size + (i % (max_size - min_size + 1))
            return [elem.example_at(i * 13 + j) for j in range(size)]

        return _Strategy(gen)

    def given(**strategies):
        names = sorted(strategies)

        def deco(fn):
            n = getattr(fn, "_hyp_max_examples", MAX_EXAMPLES)

            def runner(*args, **kwargs):
                for i in range(n):
                    ex = {k: strategies[k].example_at(i) for k in names}
                    fn(*args, **{**kwargs, **ex})

            runner.__name__ = fn.__name__
            runner.__doc__ = fn.__doc__
            return runner

        return deco

    def settings(max_examples=MAX_EXAMPLES, **_kw):
        def deco(fn):
            fn._hyp_max_examples = max_examples
            return fn

        return deco

    mod = types.ModuleType("hypothesis")
    mod.given = given
    mod.settings = settings
    st_mod = types.ModuleType("hypothesis.strategies")
    st_mod.integers = integers
    st_mod.floats = floats
    st_mod.lists = lists
    st_mod.sampled_from = sampled_from
    st_mod.binary = binary
    mod.strategies = st_mod
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = st_mod


_install_hypothesis_shim()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card; skips where CUDA is absent")
