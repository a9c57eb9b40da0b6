"""The single-writer histogram of the CUDA MoE gating kernel
(``csrc/moe_gating.cu``), written out in numpy, against the port's
``gating_ref`` and the JAX package's ``gating_pallas`` (interpret mode).

The kernel covers the ``G*T`` rows in blocks of ``R`` rows, in one launch:
a block holds the lanes (16 a row at E <= 16, 32 above) of up to 32 rows
in whole warps, and takes as many passes over that many rows as keep the
grid at 132 blocks.  Then:

* a block histograms its rows' expert ids in shared memory, one row of E
  bins per group it touches (groups ``g_first .. g_first + ng - 1``);
* a group wholly inside the block is stored straight to ``counts``;
* only the block's first and last groups can cross its edges: each such
  partial histogram goes to ``partials[block, side]`` (side 0 for the
  block's first group, 1 for its last), then the block takes a ticket from
  the counter of the group's first block ``b_lo``; the block that draws
  ticket ``b_hi - b_lo`` (the last) sums the partials of blocks ``b_lo ..
  b_hi`` (side 0 where the group is that block's first group) into
  ``counts`` and puts the counter back to 0.

Blocks run in any order, so the emulation runs them in a shuffled order and
from counters left by an earlier launch: ``counts`` must equal the
references exactly, every counter must be back at 0, and no count may be
stored twice.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.moe_gating.moe_gating import gating_pallas
from repro_torch.kernels.moe_gating.ref import gating_ref

_j_gating = jax.jit(gating_pallas, static_argnums=(1, 2, 3))


MAX_BLOCKS = 132


def rows_per_block(rows, e):
    lanes = 16 if e <= 16 else 32
    per_pass = min(32 * lanes, -(-rows * lanes // 32) * 32) // lanes
    return per_pass * max(1, -(-rows // (per_pass * MAX_BLOCKS)))


def gating_counts_blocked(ids, e, rng, tickets):
    """The kernel's histogram path.  ids [G,T,k] int (numpy); ``tickets``
    the counters (all 0 on entry, all 0 again on exit).  Returns (counts
    [G,E], how often each count was stored)."""
    g, t, _ = ids.shape
    rows = g * t
    r = rows_per_block(rows, e)
    n_blocks = -(-rows // r)
    assert n_blocks <= MAX_BLOCKS
    flat = ids.reshape(rows, -1)
    counts = np.full((g, e), -1, np.int64)         # torch.empty: garbage
    stores = np.zeros((g, e), np.int64)
    partials = np.full((n_blocks, 2, e), -7, np.int64)

    def whole(row0, gi):
        return gi * t >= row0 and gi * t + t <= row0 + r

    for b in rng.permutation(n_blocks):
        row0 = b * r
        row_end = min(rows, row0 + r)
        g_first = row0 // t
        ng = (row_end - 1) // t - g_first + 1
        hist = np.zeros((ng, e), np.int64)
        for row in range(row0, row_end):
            np.add.at(hist[row // t - g_first], flat[row], 1)
        for gl in range(ng):
            gi = g_first + gl
            if whole(row0, gi):
                counts[gi] = hist[gl]
                stores[gi] += 1
            else:
                assert gl in (0, ng - 1)
                partials[b, 0 if gl == 0 else 1] = hist[gl]
        ends = [g_first, g_first + ng - 1]
        part = [not whole(row0, ends[0]),
                ng > 1 and not whole(row0, ends[1])]
        for j in range(2):
            if not part[j]:
                continue
            gi = ends[j]
            b_lo, b_hi = gi * t // r, (gi * t + t - 1) // r
            ticket = tickets[b_lo]
            tickets[b_lo] += 1
            if ticket != b_hi - b_lo:
                continue
            counts[gi] = sum(partials[bb, 0 if gi == bb * r // t else 1]
                             for bb in range(b_lo, b_hi + 1))
            stores[gi] += 1
            tickets[b_lo] = 0
    return counts, stores


@pytest.mark.parametrize("g,t,e,k", [
    (8, 1, 16, 2), (1, 4096, 16, 2), (3, 700, 16, 2), (2, 300, 64, 8),
    (1, 513, 128, 8), (5, 100, 32, 4), (4, 64, 128, 2), (2, 257, 16, 2),
    (1, 9000, 16, 2), (1, 4096, 128, 8), (7, 1300, 16, 2)])
def test_blocked_histogram_is_phi(rng, g, t, e, k):
    logits = rng.standard_normal((g, t, e)).astype(np.float32)
    _, ids, ref = gating_ref(torch.from_numpy(logits), k)
    tickets = np.zeros(MAX_BLOCKS, np.int64)
    for launch in range(2):          # the second finds the counters at 0
        counts, stores = gating_counts_blocked(ids.numpy(), e, rng, tickets)
        np.testing.assert_array_equal(counts, ref.numpy(),
                                      err_msg=f"launch {launch}")
        assert (stores == 1).all() and not tickets.any()
    # the TPU kernel's phi for one group (interpret mode)
    if g == 1 and t * e <= 4096 * 16:
        _, _, pc = _j_gating(jnp.asarray(logits[0]), k, t, True)
        np.testing.assert_array_equal(counts[0], np.asarray(pc))
