"""The parts of the device layer that the CPU can check: the bin-match
route the dispatcher picks, the plane geometry, memory plans derived from a
device's reported limit, the compile-cache location, the BGMM's matmul
precision, the pack_planes inverse, and the csv/numpy replacements of
pandas and scikit-learn on the main path."""

import os

import numpy as np
import pytest


class TestDispatcher:
    def test_cpu_takes_the_plain_route(self):
        from poppunk_tpu.ops.match_kernel import use_kernel

        assert use_kernel() is False

    def test_plain_route_never_runs_the_kernel(self, monkeypatch):
        """On the CPU the dispatcher calls the jnp version, never the
        kernel in interpret mode."""
        from poppunk_tpu.ops import match_kernel
        from poppunk_tpu.ops.distances import match_counts_xla

        def refuse(*a, **k):
            raise AssertionError("kernel called on the CPU")

        monkeypatch.setattr(match_kernel, "match_counts_triton", refuse)
        rng = np.random.default_rng(0)
        q = rng.integers(0, 2**32, (3, 2, 4, 8), dtype=np.uint32)
        r = rng.integers(0, 2**32, (5, 2, 4, 8), dtype=np.uint32)
        got = match_kernel.match_counts(q, r, 0)
        np.testing.assert_array_equal(np.asarray(got),
                                      np.asarray(match_counts_xla(q, r, 0)))
        got_t = match_kernel.match_counts(q.transpose(1, 2, 0, 3),
                                          r.transpose(1, 2, 0, 3), 0,
                                          plane_major=True)
        np.testing.assert_array_equal(np.asarray(got_t), np.asarray(got))

    def test_other_platforms_have_no_route(self, monkeypatch):
        from poppunk_tpu.ops import match_kernel

        monkeypatch.setattr(match_kernel.jax, "default_backend",
                            lambda: "rocm")
        with pytest.raises(RuntimeError, match="no bin-match route"):
            match_kernel.use_kernel()

    def test_kernel_rejects_unchunked_word_axis(self):
        from poppunk_tpu.ops.match_kernel import match_counts_triton

        q = np.zeros((2, 1, 2, 6), np.uint32)
        with pytest.raises(ValueError, match="word chunk"):
            match_counts_triton(q, q, 0, interpret=True)


@pytest.mark.parametrize("ss64,expected", [
    (156, (312, 312, 0)),   # production geometry: no padding
    (1, (2, 4, 64)),
    (2, (4, 4, 0)),
    (17, (34, 36, 64)),
])
def test_plane_geometry_pads_to_the_word_chunk(ss64, expected):
    from poppunk_tpu.ops.distances import plane_geometry
    from poppunk_tpu.ops.match_kernel import WORD_CHUNK

    assert plane_geometry(ss64, 14) == expected
    assert expected[1] % WORD_CHUNK == 0


class _FakeDevice:
    platform = "gpu"
    device_kind = "fake GPU"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


class TestMemoryPlan:
    def test_cpu_budget_keeps_the_tested_caps(self):
        from poppunk_tpu.memory import CPU_TEST_BUDGET, memory_plan

        plan = memory_plan()
        assert plan.budget == CPU_TEST_BUDGET
        assert plan.sweep_total == 14_500_000_000
        assert plan.matmul_sweep_max_n == 20480
        assert plan.replicated_planes_max == 8_000_000_000
        assert plan.folded_buffer_max == 6_000_000_000
        assert plan.chunk_transient == 2_500_000_000

    def test_gpu_caps_follow_the_reported_limit(self):
        from poppunk_tpu.memory import memory_plan

        small = memory_plan(_FakeDevice({"bytes_limit": 16_000_000_000}))
        big = memory_plan(_FakeDevice({"bytes_limit": 64_000_000_000}))
        assert small == memory_plan()  # same limit, same plan as the CPU's
        assert big.budget == 64_000_000_000
        assert big.matmul_sweep_max_n == 2 * small.matmul_sweep_max_n
        assert big.device_sweep_max_n > small.device_sweep_max_n
        assert big.folded_buffer_max == 4 * small.folded_buffer_max
        # the dense sweep's ~18 n^2 bytes fit in half the budget
        assert 18 * big.matmul_sweep_max_n ** 2 <= big.budget // 2

    def test_gpu_without_memory_stats_raises(self):
        from poppunk_tpu.memory import memory_plan

        for stats in (None, {}, {"bytes_in_use": 0}):
            with pytest.raises(RuntimeError, match="no memory limit"):
                memory_plan(_FakeDevice(stats))


class TestCompileCache:
    def test_variable_set(self, monkeypatch, tmp_path):
        import jax

        from poppunk_tpu import configure_jax_cache, jax_cache_dir

        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
        assert jax_cache_dir() == str(tmp_path / "c")
        try:
            configure_jax_cache()
            assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
            assert os.path.isdir(tmp_path / "c")
        finally:
            jax.config.update("jax_compilation_cache_dir", before)

    def test_variable_unset_uses_the_checkout(self, monkeypatch):
        import poppunk_tpu
        from poppunk_tpu import jax_cache_dir

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        checkout = os.path.dirname(os.path.dirname(
            os.path.abspath(poppunk_tpu.__file__)))
        assert jax_cache_dir() == os.path.join(checkout, ".jax_cache")


def test_bgmm_products_ask_for_highest_precision():
    import jax
    import jax.numpy as jnp

    from poppunk_tpu.models.vbgmm import _estimate_params, _kmeans_init

    X = jnp.ones((8, 2), jnp.float32)
    resp = jnp.full((8, 2), 0.5, jnp.float32)
    prior = (0.1, jnp.zeros(2), 2.0, jnp.eye(2))
    for fn, args in ((_estimate_params, (X, resp, prior)),
                     (lambda X: _kmeans_init(jax.random.PRNGKey(0), X,
                                             jnp.ones(8), 2), (X,))):
        text = str(jax.make_jaxpr(fn)(*args))
        dots = text.count("dot_general[")
        assert dots > 0
        assert text.count("precision=(Precision.HIGHEST, Precision.HIGHEST)") \
            == dots


@pytest.mark.parametrize("plane_major", [False, True])
def test_unpack_planes_inverts_pack_planes(plane_major):
    from poppunk_tpu.ops.distances import pack_planes, unpack_planes
    from poppunk_tpu.sketch.minhash import Sketch

    rng = np.random.default_rng(3)
    klist, ss64, bbits = (15, 18, 21), 6, 3
    sketches = [Sketch(f"s{i}", {k: rng.integers(0, 2**63, ss64 * bbits,
                                                 dtype=np.uint64)
                                 for k in klist},
                       ss64, bbits, 1000 + i, 0, rng.dirichlet(np.ones(4)))
                for i in range(5)]
    planes, lengths, freqs = pack_planes(sketches, klist,
                                         plane_major=plane_major, pad_to=6)
    back = unpack_planes(planes, lengths, freqs, klist, ss64,
                         [s.name for s in sketches], plane_major=plane_major)
    for a, b in zip(sketches, back):
        assert a.name == b.name and a.length == b.length
        np.testing.assert_allclose(a.base_freq, b.base_freq, rtol=1e-6)
        for k in klist:
            np.testing.assert_array_equal(a.usigs[k], b.usigs[k])
    again, _, _ = pack_planes(back, klist, plane_major=plane_major, pad_to=6)
    np.testing.assert_array_equal(again, planes)


@pytest.mark.parametrize("a,b,want", [
    ([0, 0, 1, 1], [1, 1, 0, 0], 1.0),
    ([0, 0, 0, 1, 1, 1], [0, 0, 1, 1, 2, 2], 0.24242424242424243),
    ([0, 1, 2, 3], [0, 0, 0, 0], 0.0),
    ([0, 0, 0], [0, 0, 0], 1.0),
])
def test_adjusted_rand_index(a, b, want):
    from poppunk_tpu.utils import adjusted_rand_index

    assert adjusted_rand_index(a, b) == pytest.approx(want, abs=1e-12)
    assert adjusted_rand_index(b, a) == pytest.approx(want, abs=1e-12)


def test_cluster_csv_reader_spells_values_like_pandas(tmp_path):
    from poppunk_tpu.utils import read_isolate_type_from_csv

    path = tmp_path / "c.csv"
    path.write_text('Taxon,Cluster,Other\n"a",1,x\nb,2,\nc,10,"y"\n')
    got = read_isolate_type_from_csv(str(path), return_dict=True)
    assert dict(got["Cluster"]) == {"a": "1", "b": "2", "c": "10"}
    ext_csv = tmp_path / "e.csv"
    ext_csv.write_text('sample,Serotype\na,x\nb,\nc,"y"\n')
    ext = read_isolate_type_from_csv(str(ext_csv), mode="external",
                                     return_dict=True)
    assert dict(ext["Serotype"]) == {"a": "x", "b": "nan", "c": "y"}
    gaps = tmp_path / "g.csv"
    gaps.write_text("Taxon,Cluster\na,1\nb,\n")
    sets = read_isolate_type_from_csv(str(gaps))
    assert dict(sets["Cluster"]) == {"1.0": {"a"}, "nan": {"b"}}


def test_native_libraries_build_per_host():
    from poppunk_tpu.native_build import NATIVE_DIR, host_key, native_lib

    lib = native_lib("graph_core", openmp_optional=True)
    assert os.path.dirname(lib) == os.path.join(NATIVE_DIR, "build",
                                                host_key())
    assert os.path.isfile(lib)
    assert native_lib("graph_core", openmp_optional=True) == lib
