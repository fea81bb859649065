"""Clip-aliasing reproduction: the token scatter that clips.

Clips the block index into the table instead of *detecting* an
out-of-window position, ignores the ``active`` mask, and never routes to
the scratch page — a write past the mapped window lands on the window's
last live page and an inactive slot writes through its stale table.
``kernel_lint.lint_scatter_token`` must flag all three invariants.
"""
import torch

BATCH_AXIS = 1
SEQ_AXIS = 2


def scatter_token_clipped(pool, leaf, tables, pos, active, page_size):
    b = leaf.shape[BATCH_AXIS]
    blk = pos // page_size
    off = pos % page_size
    nblk = tables.shape[1]
    blk = blk.clamp(0, nblk - 1)         # BUG: clip, never detect
    page = torch.gather(tables, 1, blk[:, None])[:, 0]
    src = pos.clamp(0, leaf.shape[SEQ_AXIS] - 1)
    lanes = torch.arange(b, device=leaf.device)
    pool[:, page, off] = leaf[:, lanes, src]   # BUG: `active` unused
