"""poppunk_tpu — accelerator-native population partitioning using nucleotide
k-mers.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
bacpop/PopPUNK (reference: PopPUNK/__init__.py:6, v2.7.9) and its external
compute core pp-sketchlib:

- MinHash k-mer sketching of assemblies/reads (BinDash-style b-bit
  one-permutation MinHash over ntHash rolling hashes), vectorised with
  numpy on the host and JAX on device.
- All-vs-all / query-vs-reference core & accessory distances as a tiled
  Pallas (Triton) GPU kernel over packed bit-plane sketches.
- 2-D mixture model fits (variational-Bayes GMM, HDBSCAN), boundary
  refinement, lineage (sparse kNN) fits — on device via jit/vmap.
- Network construction + connected-component cluster naming, clique
  pruning, MSTs — vectorised label propagation on device with exact host
  fallbacks.
- Multi-device scaling via jax.sharding.Mesh + shard_map: the reference
  sketch tensor is sharded across devices, query tiles stream data
  parallel, distance tiles assemble through collectives.

File-format compatibility with the reference is kept where useful
(HDF5 sketch schema per PopPUNK/web.py:14-61, .dists.pkl/.npy per
PopPUNK/utils.py:135-196, cluster CSVs, model npz/pkl artefacts).
"""

__version__ = "0.1.0"

# Identifies our sketch implementation in HDF5 attrs (the reference stores a
# git hash of pp-sketchlib here; ours is a tagged string so that joins refuse
# to mix sketch provenances, PopPUNK/sketchlib.py:34).
SKETCH_VERSION = "poppunk-tpu-sketch-1"

# Lineage defaults (reference: PopPUNK/__init__.py:13-15)
SEARCH_DEPTH_FACTOR = 10
DEFAULT_LINEAGE_RESOLUTION = 1e-10


def jax_cache_dir():
    """Where the persistent compilation cache lives:
    JAX_COMPILATION_CACHE_DIR when set, else ``.jax_cache`` at the root of
    the checkout (a fixed path, so the cache's keys stay valid)."""
    import os

    return os.environ.get(
        "JAX_COMPILATION_CACHE_DIR",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".jax_cache"))


def configure_jax_cache():
    """Enable JAX's persistent compilation cache (repeat CLI invocations
    should not pay first compiles again). Called by every CLI entry
    point, the tests and the benchmarks."""
    import os

    import jax

    cache_dir = jax_cache_dir()
    try:
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    except Exception:  # cache is an optimisation, never fatal
        pass
