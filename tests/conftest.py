import os

# Tests exercising shard_map need a few host devices; smoke tests see the
# same count (cheap).  Do NOT set 512 here — that is dryrun.py's job only.
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")


def _install_hypothesis_stub():
    """Register a tiny hypothesis-compatible shim when the real library is
    absent (the container has no network; tests must not depend on pip).

    Supports exactly the subset this suite uses: ``@given`` with positional
    or keyword strategies, ``@settings(max_examples=, deadline=)`` applied
    beneath ``@given``, and the ``integers`` / ``floats`` / ``lists`` /
    ``tuples`` strategies.  Draws are deterministic per example index, and
    example 0 is the minimal draw (empty lists, zeros) so the edge cases
    hypothesis would shrink to are always exercised.
    """
    import random
    import sys
    import types

    import numpy as _np

    class _Strategy:
        def __init__(self, draw):
            self.draw = draw  # (random.Random, minimal: bool) -> value

    def integers(min_value=0, max_value=2**31 - 1):
        def draw(r, minimal):
            return min_value if minimal else r.randint(min_value, max_value)

        return _Strategy(draw)

    def floats(width=64, allow_nan=True, allow_infinity=True, **_):
        def draw(r, minimal):
            if minimal:
                return 0.0
            roll = r.random()
            if roll < 0.15:
                v = float(r.choice([0.0, -0.0, 1.0, -1.0, 2.0**-20, 2.0**20]))
            else:
                v = r.uniform(-1.0, 1.0) * 10.0 ** r.randint(-8, 8)
            if width == 32:
                v = float(_np.float32(v))
            return v

        return _Strategy(draw)

    def lists(elements, min_size=0, max_size=None):
        cap = 10 if max_size is None else max_size

        def draw(r, minimal):
            size = min_size if minimal else r.randint(min_size, cap)
            return [elements.draw(r, minimal) for _ in range(size)]

        return _Strategy(draw)

    def tuples(*elems):
        def draw(r, minimal):
            return tuple(e.draw(r, minimal) for e in elems)

        return _Strategy(draw)

    def settings(max_examples=20, deadline=None, **_):
        def deco(fn):
            fn._stub_max_examples = max_examples
            return fn

        return deco

    def given(*gargs, **gkwargs):
        def deco(fn):
            max_examples = getattr(fn, "_stub_max_examples", 20)

            def wrapper():
                for i in range(max_examples):
                    r = random.Random(0xA11CE + i)
                    minimal = i == 0
                    args = [s.draw(r, minimal) for s in gargs]
                    kwargs = {k: s.draw(r, minimal) for k, s in gkwargs.items()}
                    fn(*args, **kwargs)

            # zero-arg wrapper on purpose: pytest must not mistake the
            # strategy parameters for fixtures.
            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            return wrapper

        return deco

    st_mod = types.ModuleType("hypothesis.strategies")
    st_mod.integers = integers
    st_mod.floats = floats
    st_mod.lists = lists
    st_mod.tuples = tuples

    mod = types.ModuleType("hypothesis")
    mod.given = given
    mod.settings = settings
    mod.strategies = st_mod
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = st_mod


try:
    import hypothesis  # noqa: F401
except ImportError:
    _install_hypothesis_stub()

import jax  # noqa: E402

from repro import compat
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips inside the test without one)"
    )


@pytest.fixture(scope="session")
def mesh11():
    return compat.make_mesh((1, 1), ("data", "model"))


@pytest.fixture(scope="session")
def mesh22():
    return compat.make_mesh((2, 2), ("data", "model"))


@pytest.fixture()
def rng():
    return np.random.default_rng(0)
