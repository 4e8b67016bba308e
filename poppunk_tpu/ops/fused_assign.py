"""Fused distance + model-classification post-ops.

The reference's serving path (PopPUNK/assign.py:502 then models.py:1085 /
models.py:411-464) computes the query-vs-reference distance matrix in one
native call, ships it to Python, then re-walks every pair in a second pass
to classify it against the fitted model. On a device that second pass
would mean re-uploading the whole |Q|x|R| matrix through the host.
Instead the classifier runs inside the same jit as the distance kernel,
on the tile that is already in device memory — one dispatch per query
chunk returns both the distances and the per-pair assignment.

A post-op is identified by a static string (jit-cache key) plus a static
tuple and a pytree of device parameters:

    spec = (name, static, params)
    POST_FNS[name](dists, params, static) -> extra output

``model_post_spec(model, slope)`` builds the spec for any model that
supports device classification (refine/threshold boundaries, BGMM
likelihood argmax); returns None otherwise (the caller falls back to the
two-pass route).
"""

import jax.numpy as jnp
import numpy as np


def _boundary_sign(dists, params, slope):
    scale, x_max, y_max = params
    Xs = dists.reshape(-1, 2) / scale
    x0 = Xs[:, 0]
    y0 = Xs[:, 1]
    if slope == 2:
        d = jnp.where(
            (x_max == 0) | (y_max == 0),
            jnp.sqrt(x0 * x0 + y0 * y0),
            y0 * x_max + x0 * y_max - x_max * y_max,
        )
    elif slope == 0:
        d = x0 - x_max
    elif slope == 1:
        d = y0 - y_max
    else:
        raise ValueError("slope must be 0, 1 or 2")
    # int8: the sign fits, and serving fetches only this array to the host
    return jnp.sign(d).astype(jnp.int8)


def _post_boundary(dists, params, static):
    """Sign of each pair vs a 2-D line boundary — jnp twin of
    ops/boundary.assign_threshold (reference src/boundary.cpp:42-80).
    Within-strain pairs are -1. Output shape = dists.shape[:-1]."""
    (slope,) = static
    return _boundary_sign(dists, params, slope).reshape(dists.shape[:-1])


def _post_boundary_stable(dists, params, static):
    """Fully-fused --stable serving: per query, the 1-NN reference on the
    chosen distance column and whether that pair is within-strain
    (reference assign.py:663-693 semantics — first min on ties). Output
    int32[nq, 2] of (nn_index, within_flag): O(queries) host fetch, the
    |Q|x|R| tile never leaves the device."""
    slope, dist_col = static
    sign = _boundary_sign(dists, params, slope).reshape(dists.shape[:-1])
    rect = dists[..., dist_col]  # [nq, nr]
    nn = jnp.argmin(rect, axis=-1)  # first min on ties, like np.argmin
    within = jnp.take_along_axis(sign, nn[..., None], axis=-1)[..., 0] == -1
    return jnp.stack([nn.astype(jnp.int32), within.astype(jnp.int32)],
                     axis=-1)


def _post_bgmm_stable(dists, params, static):
    """Fused --stable serving for BGMM models: (nn_index, within_flag)
    per query, within = the nearest pair's component argmax equals the
    model's within label."""
    from ..models.bgmm import log_likelihood_device

    (dist_col, within_label) = static
    weights, means, covariances, scale = params
    _, lpr = log_likelihood_device(
        dists.reshape(-1, 2), weights, means, covariances, scale)
    comp = jnp.argmax(lpr, axis=1).reshape(dists.shape[:-1])
    rect = dists[..., dist_col]
    nn = jnp.argmin(rect, axis=-1)
    within = jnp.take_along_axis(comp, nn[..., None], axis=-1)[..., 0] \
        == within_label
    return jnp.stack([nn.astype(jnp.int32), within.astype(jnp.int32)],
                     axis=-1)


def _post_bgmm(dists, params, static):
    """Component argmax of the weighted Gaussian log-likelihood — same math
    as models/bgmm._assign_chunk (reference PopPUNK/bgmm.py:100-174)."""
    from ..models.bgmm import log_likelihood_device

    weights, means, covariances, scale = params
    _, lpr = log_likelihood_device(
        dists.reshape(-1, 2), weights, means, covariances, scale)
    # int8 holds any practical component count (reference K <= 10)
    return jnp.argmax(lpr, axis=1).astype(jnp.int8).reshape(
        dists.shape[:-1])


def _dbscan_grid_label(dists, params):
    """Cluster label per pair from the quantised approximate_predict grid
    (DBSCANFit.decision_grid): scale, locate cell, gather."""
    grid, x0, dx, y0, dy, scale = params
    res = grid.shape[0]
    Xs = dists.reshape(-1, 2) / scale
    ix = jnp.clip(((Xs[:, 0] - x0) / dx).astype(jnp.int32), 0, res - 1)
    iy = jnp.clip(((Xs[:, 1] - y0) / dy).astype(jnp.int32), 0, res - 1)
    return grid[ix, iy]


def _post_dbscan(dists, params, static):
    """Predicted HDBSCAN cluster per pair (reference
    PopPUNK/models.py:192 approximate_predict semantics, grid-quantised).
    Output int8, shape = dists.shape[:-1]."""
    return _dbscan_grid_label(dists, params).reshape(dists.shape[:-1])


def _post_dbscan_stable(dists, params, static):
    """Fused --stable serving for DBSCAN models: (nn_index, within_flag)
    per query; within = the nearest pair's grid label equals the model's
    within label."""
    dist_col, within_label = static
    lab = _dbscan_grid_label(dists, params).reshape(dists.shape[:-1])
    rect = dists[..., dist_col]
    nn = jnp.argmin(rect, axis=-1)
    within = jnp.take_along_axis(lab, nn[..., None], axis=-1)[..., 0] \
        == within_label
    return jnp.stack([nn.astype(jnp.int32), within.astype(jnp.int32)],
                     axis=-1)


POST_FNS = {
    "boundary": _post_boundary,
    "boundary_stable": _post_boundary_stable,
    "bgmm": _post_bgmm,
    "bgmm_stable": _post_bgmm_stable,
    "dbscan": _post_dbscan,
    "dbscan_stable": _post_dbscan_stable,
}


def stable_post_spec(model, dist_col):
    """(name, static, params) for the fused --stable serving post
    (1-NN + within check on device) — refine/threshold, BGMM and DBSCAN."""
    base = model_post_spec(model)
    if base is None:
        return None
    name, static, params = base
    if name == "boundary":
        return ("boundary_stable", (static[0], int(dist_col)), params)
    if name == "bgmm":
        return ("bgmm_stable", (int(dist_col), int(model.within_label)),
                params)
    if name == "dbscan":
        return ("dbscan_stable", (int(dist_col), int(model.within_label)),
                params)
    return None


def apply_post(dists, post_spec):
    """Run a post-op inside a jit. post_spec = (name, static, params)."""
    name, static, params = post_spec
    return POST_FNS[name](dists, params, static)


def model_post_spec(model, slope=None):
    """(name, static, params) classifying pairs like ``model.assign`` —
    or None if the model has no device classifier (lineage). dbscan uses
    a quantised decision grid built from the exact host predictor:
    exact for any pair more than half a grid cell from a decision
    boundary (serve.py module docstring)."""
    if getattr(model, "type", None) == "refine":
        if slope is None:
            slope = model.slope
        scale = jnp.asarray(model.scale, jnp.float32)
        if slope == 2:
            x_max, y_max = model.optimal_x, model.optimal_y
        elif slope == 0:
            x_max, y_max = model.core_boundary, 0.0
        else:
            x_max, y_max = 0.0, model.accessory_boundary
        params = (scale, jnp.float32(x_max), jnp.float32(y_max))
        return ("boundary", (int(slope),), params)
    if getattr(model, "type", None) == "bgmm":
        params = (
            jnp.asarray(model.weights, jnp.float32),
            jnp.asarray(model.means, jnp.float32),
            jnp.asarray(model.covariances, jnp.float32),
            jnp.asarray(model.scale, jnp.float32),
        )
        return ("bgmm", (), params)
    if getattr(model, "type", None) == "dbscan" and hasattr(model, "hdb"):
        grid, x0, dx, y0, dy = model.decision_grid()
        params = (
            jnp.asarray(grid),
            jnp.float32(x0), jnp.float32(dx),
            jnp.float32(y0), jnp.float32(dy),
            jnp.asarray(model.scale, jnp.float32),
        )
        return ("dbscan", (), params)
    return None


def assign_oracle(model, dist_mat, slope=None):
    """Host-path assignment with the same slope resolution as
    model_post_spec (for tests and fallbacks)."""
    if slope is None:
        return np.asarray(model.assign(dist_mat))
    return np.asarray(model.assign(dist_mat, slope=slope))
