"""Neighbour joining on device.

The reference shells out to the external rapidnj C++ binary for large
trees (PopPUNK/trees.py:31-72); here the O(n^3) NJ main loop runs on the
device instead: the distance matrix stays resident, every step evaluates
the full masked Q matrix with elementwise ops + row reductions and records
the join; the host replays the O(n) join log into a tree.

Agreement with the host numpy NJ is asserted via patristic distance
matrices (topologically identical trees up to rotation).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_INF = jnp.float32(3.4e38)


@partial(jax.jit, static_argnames=("n",))
def _nj_joins(D, n):
    """Join log for NJ over an [n, n] f32 distance matrix.

    Returns (i, j, li, lj) arrays of length n-2 plus the final pair
    distance. Slot j is deactivated at each step; slot i holds the new
    internal node.
    """
    active0 = jnp.ones(n, dtype=bool)

    def step(state, _):
        D, active, m = state
        amask = active.astype(jnp.float32)
        pair_mask = amask[:, None] * amask[None, :]
        r = (D * pair_mask).sum(axis=1)
        Q = (m - 2.0) * D - r[:, None] - r[None, :]
        eye = jnp.eye(n, dtype=bool)
        Q = jnp.where((pair_mask > 0) & ~eye, Q, _INF)
        flat = jnp.argmin(Q)
        i = (flat // n).astype(jnp.int32)
        j = (flat % n).astype(jnp.int32)
        i, j = jnp.minimum(i, j), jnp.maximum(i, j)
        dij = D[i, j]
        li = 0.5 * dij + (r[i] - r[j]) / (2.0 * (m - 2.0))
        lj = dij - li
        li = jnp.maximum(li, 0.0)
        lj = jnp.maximum(lj, 0.0)

        new_row = 0.5 * (D[i, :] + D[j, :] - dij)
        D = D.at[i, :].set(new_row)
        D = D.at[:, i].set(new_row)
        D = D.at[i, i].set(0.0)
        active = active.at[j].set(False)
        return (D, active, m - 1.0), (i, j, li, lj)

    (D, active, _), joins = jax.lax.scan(
        step, (D, active0, jnp.float32(n)), None, length=n - 2)
    # distance between the last two active slots
    amask = active.astype(jnp.float32)
    pair = amask[:, None] * amask[None, :] * (1 - jnp.eye(n))
    last_d = (D * pair).sum() / 2.0
    last_slots = jnp.nonzero(active, size=2)[0].astype(jnp.int32)
    return joins, last_slots, last_d


def neighbor_joining_device(D, labels):
    """Device twin of trees.neighbor_joining; returns the same Node tree
    type (joined on host from the device join log)."""
    from ..trees import Node

    n = D.shape[0]
    if n < 3:
        from ..trees import neighbor_joining

        return neighbor_joining(D, labels)
    joins, last_slots, last_d = _nj_joins(
        jnp.asarray(np.asarray(D, dtype=np.float32)), int(n))
    i_arr, j_arr, li_arr, lj_arr = (np.asarray(x) for x in joins)
    last_slots = np.asarray(last_slots)
    last_d = float(last_d)

    nodes = [Node(lab) for lab in labels]
    for i, j, li, lj in zip(i_arr, j_arr, li_arr, lj_arr):
        parent = Node()
        nodes[i].edge_length = float(li)
        nodes[j].edge_length = float(lj)
        parent.add_child(nodes[i])
        parent.add_child(nodes[j])
        nodes[i] = parent

    a, b = int(last_slots[0]), int(last_slots[1])
    root = Node()
    nodes[a].edge_length = last_d / 2
    nodes[b].edge_length = last_d / 2
    root.add_child(nodes[a])
    root.add_child(nodes[b])
    return root


# Below this size the host numpy loop beats device dispatch overhead.
DEVICE_NJ_MIN_N = 512


def use_device_nj(n):
    return n >= DEVICE_NJ_MIN_N and jax.default_backend() != "cpu"
