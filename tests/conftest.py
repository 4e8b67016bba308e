"""Test configuration.

Tests run on the CPU (JAX_PLATFORMS=cpu unless set otherwise) with an
8-device virtual mesh, so sharding logic is exercised without several
cards. Tests marked ``gpu`` need the card: they take the ``gpu`` fixture,
which skips them elsewhere. On the card, chip_smoke.py runs them, or
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest

import jax

from poppunk_tpu import configure_jax_cache

configure_jax_cache()

from synth_genomes import SyntheticPopulation


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided per test, never
    at import, so every test worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run on the card (chip_smoke.py, or "
                    "JAX_PLATFORMS=cuda pytest -m gpu tests/test_gpu.py)")


@pytest.fixture(scope="session")
def population():
    """A small synthetic bacterial population with clear strain structure."""
    return SyntheticPopulation(
        n_strains=4,
        genomes_per_strain=(5, 4, 3, 3),
        genome_length=80_000,
        core_mutation_rate=0.008,
        between_divergence=0.035,
        accessory_pool=40,
        accessory_gene_len=2_000,
        seed=20260816,
    )


@pytest.fixture(scope="session")
def population_dir(population, tmp_path_factory):
    """Population written as FASTA files + rfile, PopPUNK-style."""
    d = tmp_path_factory.mktemp("genomes")
    rfile = population.write_fastas(d)
    return d, rfile
