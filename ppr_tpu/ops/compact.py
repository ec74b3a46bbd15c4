"""Device-side threshold compaction: ship only the kept nonzeros.

BASE preprocessing (Base_Whole_Graph.java:76-92) keeps just the entries
``pi(v, t) >= threshold`` of each reverse-push reserve, but a naive port
ships the full dense ``[T, n_pad]`` batch to the host first: 275 GB for
an amazon-scale all-pair sweep, which on any device->host link dwarfs the
compute. This kernel selects on device (cumsum positions + one linear
scatter, pow2-capacity-bucketed so only O(log nnz) program shapes ever
compile) and ships ``count * 8`` bytes instead of ``T * n_pad * 4``.

A density guard falls back to the dense copy when the kept fraction is
high enough that (flat-index, value) pairs would cost more bytes than the
dense matrix (tight-threshold sweeps on small graphs, e.g. grqc at 5e-7).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _pow2_at_least(x: int, lo: int = 1024) -> int:
    c = lo
    while c < x:
        c <<= 1
    return c


@partial(jax.jit, static_argnums=(1, 5))
def _compact(p, cap, threshold, node_mask, row_mask, exclusive):
    """Return (flat_idx i32[cap], val f32[cap]) of kept entries, packed in
    flat order; slots past the true count stay zero."""
    keep = (p > threshold) if exclusive else (p >= threshold)
    mask = keep & (node_mask > 0)[None, :] & row_mask[:, None]
    flat_mask = mask.reshape(-1)
    flat_val = p.reshape(-1)
    pos = jnp.cumsum(flat_mask.astype(jnp.int32)) - 1
    # non-kept entries target index `cap`, which is out of bounds for the
    # [cap]-sized outputs and dropped by the scatter
    idx = jnp.where(flat_mask, pos, cap)
    src = jnp.arange(flat_mask.shape[0], dtype=jnp.int32)
    out_idx = jnp.zeros(cap, jnp.int32).at[idx].set(src, mode="drop")
    out_val = jnp.zeros(cap, jnp.float32).at[idx].set(flat_val, mode="drop")
    return out_idx, out_val


@partial(jax.jit, static_argnums=4)
def _count_kept(p, threshold, node_mask, row_mask, exclusive):
    keep = (p > threshold) if exclusive else (p >= threshold)
    mask = keep & (node_mask > 0)[None, :] & row_mask[:, None]
    # int32 is safe: threshold_nonzeros rejects t * n_pad >= 2^31
    return jnp.sum(mask, dtype=jnp.int32)


def threshold_nonzeros(p, node_mask, threshold, *, rows: int | None = None,
                       exclusive: bool = False):
    """Entries of device array ``p [T, n_pad]`` with value >= threshold
    (``exclusive=True``: strictly > threshold, e.g. ``> 0`` to match the
    store's keep-positive semantics exactly, subnormals included).

    Returns host arrays ``(row i64[count], col i64[count], val f32[count])``
    in row-major order. ``rows`` limits selection to the first rows
    (padding rows of a sharded batch). Falls back to a dense host copy when
    the kept set is too dense for the sparse wire format to pay off.
    """
    t, n_pad = p.shape
    if t * n_pad >= np.iinfo(np.int32).max:
        raise ValueError(f"flat index overflow: batch {t} x {n_pad}; "
                         "use a smaller target batch")
    row_mask = jnp.arange(t) < (t if rows is None else int(rows))
    thr = jnp.float32(threshold)
    count = int(_count_kept(p, thr, node_mask, row_mask, exclusive))
    if count == 0:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.float32)
    # compare what the sparse path actually ships — the pow2 capacity, up
    # to 2x count — against the dense copy
    if _pow2_at_least(count) * 8 >= t * n_pad * 4:
        dense = np.asarray(p)
        if rows is not None:
            dense = dense[:rows]
        nm = np.asarray(node_mask) > 0
        keep = (dense > float(threshold)) if exclusive \
            else (dense >= float(threshold))
        r, c = np.nonzero(keep & nm[None, :])
        return r.astype(np.int64), c.astype(np.int64), dense[r, c]
    cap = _pow2_at_least(count)
    out_idx, out_val = _compact(p, cap, thr, node_mask, row_mask, exclusive)
    # host-side slice: device slicing by a varying `count` would compile a
    # new program per value; shipping the pow2 cap is at most 2x count
    flat = np.asarray(out_idx, np.int64)[:count]
    val = np.asarray(out_val, np.float32)[:count]
    return flat // n_pad, flat % n_pad, val
