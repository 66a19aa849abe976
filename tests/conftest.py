"""Test configuration: run everything on a virtual 8-device CPU mesh.

Tests must not depend on TPU availability; multi-chip sharding is validated
on the forced host-platform device mesh. jax.config.update is used (rather
than env vars) because the test harness may import jaxlib before this file.
"""
import os

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where there is none")


def ref_build_skip(msg: str):
    """Reference-build failure policy for the parity harnesses: skip by
    default (the suite must pass without a C toolchain), but HARD FAIL under
    LPCNET_REQUIRE_REF=1 so a toolchain regression cannot silently drop the
    bit-exactness evidence (every tools/ref_* fixture routes through this)."""
    import pytest
    if os.environ.get("LPCNET_REQUIRE_REF") == "1":
        pytest.fail(f"LPCNET_REQUIRE_REF=1 but {msg}")
    pytest.skip(msg)
