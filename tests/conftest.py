import jax
import pytest

# Tests run on the single CPU device (dry-run owns the 512-device trick).
jax.config.update("jax_platform_name", "cpu")


def pytest_configure(config):
    # Escalate the repro deprecation shims (PackedCodes, client_transmit,
    # IngestBuffer, ...) to errors: no internal code path may silently
    # construct a deprecated carrier. Every shim's message says which
    # repro.* replacement to use, which is what the filter keys on.
    # (Tests that exercise the shims on purpose use pytest.warns, which
    # overrides these filters inside its block.)
    config.addinivalue_line(
        "filterwarnings", r"error:.*use repro\.:DeprecationWarning")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without one")


def abstract_mesh(sizes, names):
    """AbstractMesh across jax versions: new (sizes, names) signature vs
    the 0.4.x ((name, size), ...) pair tuple."""
    try:
        return jax.sharding.AbstractMesh(sizes, names)
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(zip(names, sizes)))


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)
