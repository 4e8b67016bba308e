"""Device memory plans, derived from what the device reports.

Every size decision that depends on device memory (dense versus sparse
refine sweeps, resident versus streamed condensed buffers, replicated
versus column-sharded sketch planes, streaming chunk sizes) reads its cap
from ``memory_plan()``. Each cap is a working-set formula from the module
that uses it, solved against the bytes the device's allocator may hand
out (``memory_stats()["bytes_limit"]``).
"""

from typing import NamedTuple

import jax

# The CPU backend reports no memory statistics. Its tests plan against
# this budget, so their routing (dense versus sparse sweeps, streaming
# switches) is the same on every host.
CPU_TEST_BUDGET = 16_000_000_000

# Granularity of the dense-square vertex caps (a multiple of every chunk
# size the folded layout uses).
_N_STEP = 2048


class MemoryPlan(NamedTuple):
    budget: int
    """Bytes the device allocator may hand out."""
    sweep_total: int
    """Working-set cap of the device sparse sweep (ops/sparse_sweep
    .hbm_feasible): the budget less the runtime's own buffers."""
    matmul_sweep_max_n: int
    """Largest n for the dense matmul sweep, whose working set is ~18 n^2
    bytes (the d0 square, A, bf16 A and the product, 14 n^2, on top of
    the resident folded buffer, 4 n^2) in half the budget; the other half
    holds the sketch planes and XLA's temporaries."""
    device_sweep_max_n: int
    """Largest n for ops/device_sweep's dense scorer: two [n, n] f32
    buffers (8 n^2 bytes) in half the budget."""
    replicated_planes_max: int
    """Above this many bytes of sketch planes per device, a mesh splits
    the planes by column instead of replicating them (half the budget)."""
    folded_buffer_max: int
    """Above this many bytes per device, the folded condensed buffer
    (4 n^2 bytes over the devices) is not kept and the pipeline streams."""
    chunk_transient: int
    """Per-step transients of a streaming pass (~16 bytes x 2c x n x K
    across the match, correction and fit buffers) budget for the chunk
    size c."""


def device_budget(device=None):
    """Bytes the allocator of ``device`` (default: the first) may use."""
    device = device if device is not None else jax.devices()[0]
    if device.platform == "cpu":
        return CPU_TEST_BUDGET
    stats = device.memory_stats()
    if not stats or "bytes_limit" not in stats:
        raise RuntimeError(
            f"{device.device_kind} reports no memory limit; cannot plan "
            "device memory")
    return int(stats["bytes_limit"])


def _max_n(bytes_per_n2, budget):
    n = int((budget / bytes_per_n2) ** 0.5)
    return n - n % _N_STEP


def memory_plan(device=None):
    """The caps of every memory decision for ``device``."""
    budget = device_budget(device)
    half = budget // 2
    return MemoryPlan(
        budget=budget,
        sweep_total=budget * 29 // 32,
        matmul_sweep_max_n=_max_n(18, half),
        device_sweep_max_n=_max_n(8, half),
        replicated_planes_max=half,
        folded_buffer_max=budget * 3 // 8,
        chunk_transient=budget * 5 // 32,
    )
