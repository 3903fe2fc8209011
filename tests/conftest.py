import os
import pathlib
import subprocess
import sys

# The CPU run: sharding tests need a multi-device mesh, so tests run on a
# virtual 11-device CPU platform (11 = a non-trivial divisor of CIF's 22
# MB columns, so the tile_shards tests can run the maximum column split;
# gop tests use 8), with x64 on for the exact (float64) conformance path.
# ICSP_TEST_GPU=1 leaves the platform as the caller set it up, so that the
# gpu-marked tests can run on the card inside an already started process
# (chip_smoke.py runs them that way).
if os.environ.get("ICSP_TEST_GPU", "0") != "1":
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=11"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import pytest  # noqa: E402

GOLDEN = REPO / "tests" / "golden"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; run on the card by `python chip_smoke.py`"
    )


@pytest.fixture
def gpu():
    """The GPU devices; skips the test where JAX sees none."""
    import jax

    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs a GPU (JAX sees none); run `python chip_smoke.py` on the card")
    return devices


@pytest.fixture(scope="session")
def golden_dir():
    """Golden artifacts from the C++ reference; regenerated on demand
    (they are gitignored — only MANIFEST.sha256 is committed)."""
    if not (GOLDEN / "synthA_compCIF_16_16_1.bin").exists():
        if not pathlib.Path("/root/reference").exists():
            pytest.skip("reference codec not available to generate goldens")
        subprocess.run(
            ["bash", str(REPO / "tools" / "gen_golden.sh")],
            check=True,
            capture_output=True,
        )
    return GOLDEN
