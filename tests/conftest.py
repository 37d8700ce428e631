"""Shared fixtures. NOTE: no XLA_FLAGS here — unit tests run on 1 CPU
device by design; multi-device tests spawn subprocesses with their own
--xla_force_host_platform_device_count (see test_distributed.py).

`hypothesis` is an *optional* dev dependency (requirements-dev.txt).
When it is missing we install a stub into sys.modules before the test
modules import it, so collection succeeds: @given tests become zero-arg
tests that skip with a pointer to requirements-dev.txt, and every other
test in those modules still runs.

When hypothesis IS present, two settings profiles are registered (the
property tests themselves never pin max_examples, so the profile is in
charge):
  - "dev" (default): few examples, no deadline — fast local iteration.
  - "ci": more examples, derandomized (fixed seed) so CI runs are
    reproducible and actually exercise the properties. Selected via
    HYPOTHESIS_PROFILE=ci (set by .github/workflows/ci.yml).
"""
import os
import sys
import types

import jax
import pytest

try:
    import hypothesis
    hypothesis.settings.register_profile(
        "dev", deadline=None, max_examples=10)
    hypothesis.settings.register_profile(
        "ci", deadline=None, max_examples=50, derandomize=True,
        print_blob=True)
    hypothesis.settings.load_profile(
        os.environ.get("HYPOTHESIS_PROFILE", "dev"))
except ImportError:
    def _skip_given(*_strategies, **_kw):
        def deco(fn):
            def skipper():
                pytest.skip("hypothesis not installed "
                            "(pip install -r requirements-dev.txt)")
            skipper.__name__ = fn.__name__
            skipper.__doc__ = fn.__doc__
            return skipper
        return deco

    def _passthrough(*_a, **_kw):
        return lambda fn: fn

    _stub = types.ModuleType("hypothesis")
    _stub.given = _skip_given
    _stub.settings = _passthrough
    _stub.assume = lambda *_a, **_kw: True
    _strategies = types.ModuleType("hypothesis.strategies")
    _strategies.__getattr__ = lambda name: (lambda *_a, **_kw: None)
    _stub.strategies = _strategies
    sys.modules["hypothesis"] = _stub
    sys.modules["hypothesis.strategies"] = _strategies


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (the port's hand-written "
        "kernels); skips with a reason where there is none")
