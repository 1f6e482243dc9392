"""Plain reference rasterizer: every (primitive, pixel) pair a primitive's
bbox window can cover, the exact coverage and depth test, and the
per-pixel lexicographic (depth, id) minimum by a scatter of int64 keys.

The candidate pixels of a primitive are the pixel centres inside its
bbox, as the reference oracle takes them (col + 0.5 in [xmin, xmax],
row + 0.5 in [ymin, ymax]).  A capsule's window is narrowed row by row
to the part of the row its segment can reach (the segment's extent in
the row's slab, widened by its radius and one pixel), which leaves out
only pixels that no capsule test can accept.  The pairs go in blocks of
``BLOCK_PAIRS``, so any frame fits in a few GiB.

The test of one pair, as written here, is also what the roofline
readers count (``OPS_PER_PAIR``).
"""

from __future__ import annotations

import torch

from portbench.reference.scene import KIND_CAPSULE, KIND_DISC, \
    KIND_TRIANGLE, Soup

BLOCK_PAIRS = 1 << 25
PRIM_BLOCK = 1 << 20
EMPTY = torch.iinfo(torch.int64).max
MARGIN_PX = 1.0

# float32 operations of one pair test below, counted from its expressions:
# disc or capsule: dx, dy (2); t = clamp((dx*p4 + dy*p5)*p8) (3 mul/add,
# 1 mul, 2 clamps); cx, cy (4); rad = p3 + p7 t (2); cx cx + cy cy (3);
# rad rad and the compare (2); depth p2 + p6 t (2): 21.  A triangle:
# three edge functions (4 each), iz (5), four compares, 1 / iz: 22.
OPS_PER_PAIR = {KIND_DISC: 21, KIND_CAPSULE: 21, KIND_TRIANGLE: 22}
# float32 fields the test reads: p0..p8 (discs, capsules), p0..p11.
FIELDS_READ = {KIND_DISC: 9, KIND_CAPSULE: 9, KIND_TRIANGLE: 12}


def _window(lo, hi, limit):
    """First and last pixel whose centre lies in [lo, hi], in 0..limit-1."""
    first = torch.clamp(torch.ceil(lo - 0.5), min=0)
    last = torch.clamp(torch.floor(hi - 0.5), max=limit - 1)
    return first.to(torch.int64), last.to(torch.int64)


def _capsule_cols(p, unit, yc, c0, c1):
    """Narrow the columns of capsule ``unit`` (rows of params ``p``) in
    the row whose centre is ``yc``: the segment's points within R of the
    row, widened by R + MARGIN_PX."""
    x0, y0, r0, dx, dy, dr = (p[:, k][unit] for k in (0, 1, 3, 4, 5, 7))
    big_r = torch.maximum(r0, r0 + dr) + MARGIN_PX
    flat = dy.abs() < 1e-12
    safe = torch.where(flat, torch.ones_like(dy), dy)
    ta = (yc - big_r - y0) / safe
    tb = (yc + big_r - y0) / safe
    t_lo = torch.clamp(torch.minimum(ta, tb), 0.0, 1.0)
    t_hi = torch.clamp(torch.maximum(ta, tb), 0.0, 1.0)
    t_lo = torch.where(flat, torch.zeros_like(t_lo), t_lo)
    t_hi = torch.where(flat, torch.ones_like(t_hi), t_hi)
    xa, xb = x0 + dx * t_lo, x0 + dx * t_hi
    lo = torch.floor(torch.minimum(xa, xb) - big_r - 0.5).to(torch.int64)
    hi = torch.ceil(torch.maximum(xa, xb) + big_r - 0.5).to(torch.int64)
    return torch.maximum(c0, lo), torch.minimum(c1, hi)


def _test(kind: int, p, qx, qy):
    """(covered, depth) of pairs of one kind: the reference's expressions."""
    def c(i):
        return p[:, i]
    if kind == KIND_TRIANGLE:
        e0 = c(0) * qy - c(1) * qx + c(2)
        e1 = c(3) * qy - c(4) * qx + c(5)
        e2 = c(6) * qy - c(7) * qx + c(8)
        iz = e0 * c(9) + e1 * c(10) + e2 * c(11)
        cov = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (iz > 0)
        safe = torch.where(iz > 0, iz, torch.ones_like(iz))
        return cov, torch.ones_like(safe) / safe
    dx = qx - c(0)
    dy = qy - c(1)
    t = torch.clamp((dx * c(4) + dy * c(5)) * c(8), 0.0, 1.0)
    cx = dx - t * c(4)
    cy = dy - t * c(5)
    rad = c(3) + c(7) * t
    return cx * cx + cy * cy <= rad * rad, c(2) + c(6) * t


def _pairs(rows_of, cols_lo, cols_hi):
    """Expand (unit, column range) runs to (unit, column) pairs."""
    n = torch.clamp(cols_hi - cols_lo + 1, min=0)
    unit = torch.repeat_interleave(rows_of, n)
    start = torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    col = torch.arange(unit.shape[0], device=unit.device) - start \
        + torch.repeat_interleave(cols_lo, n)
    return unit, col


class KeyBuffer:
    """Per-pixel int64 keys (depth bits << 32 | id), EMPTY where nothing
    covers; the minimum key is the lexicographic (depth, id) minimum,
    since every drawn depth is positive and finite."""

    def __init__(self, width: int, height: int, device):
        self.width, self.height = width, height
        self.keys = torch.full((height * width,), EMPTY, dtype=torch.int64,
                               device=device)
        self.accepted = {KIND_DISC: 0, KIND_CAPSULE: 0, KIND_TRIANGLE: 0}
        self.prims = {KIND_DISC: 0, KIND_CAPSULE: 0, KIND_TRIANGLE: 0}

    def draw(self, soup: Soup):
        """Fold every valid primitive of ``soup`` into the keys, counting
        the pairs each kind's test accepts and the primitives it reads."""
        w, h = self.width, self.height
        for kind in (KIND_DISC, KIND_CAPSULE, KIND_TRIANGLE):
            ids = torch.nonzero(soup.valid & (soup.kind == kind))[:, 0]
            self.prims[kind] += int(ids.numel())
            for lo in range(0, ids.numel(), PRIM_BLOCK):
                self._draw_kind(soup, kind, ids[lo:lo + PRIM_BLOCK], w, h)

    def _draw_kind(self, soup, kind, ids, w, h):
        bbox = soup.bbox[ids]
        c0, c1 = _window(bbox[:, 0], bbox[:, 1], w)
        r0, r1 = _window(bbox[:, 2], bbox[:, 3], h)
        local = torch.arange(ids.numel(), device=ids.device)
        unit, row = _pairs(local, r0, r1)  # (prim, row) runs
        lo, hi = c0[unit], c1[unit]
        if kind == KIND_CAPSULE:
            yc = row.to(torch.float32) + 0.5
            lo, hi = _capsule_cols(soup.params[ids], unit, yc, lo, hi)
        width = torch.clamp(hi - lo + 1, min=0)
        ends = torch.cumsum(width, 0)
        total = int(ends[-1]) if ends.numel() else 0
        start = 0
        while start < total:
            # The runs whose pairs fall in [start, start + BLOCK_PAIRS).
            a = int(torch.searchsorted(ends, start, right=True))
            b = int(torch.searchsorted(ends, start + BLOCK_PAIRS, right=True))
            b = max(b, a + 1)
            run, col = _pairs(torch.arange(a, b, device=ids.device),
                              lo[a:b], hi[a:b])
            self._fold(soup, kind, ids, unit[run], row[run], col)
            start = int(ends[b - 1])

    def _fold(self, soup, kind, ids, prim, row, col):
        pid = ids[prim]
        qx = col.to(torch.float32) + 0.5
        qy = row.to(torch.float32) + 0.5
        cov, depth = _test(kind, soup.params[pid], qx, qy)
        self.accepted[kind] += int(cov.sum())
        key = (depth.view(torch.int32).to(torch.int64) << 32) | pid
        key = torch.where(cov, key, torch.full_like(key, EMPTY))
        self.keys.scatter_reduce_(0, row * self.width + col, key, "amin")

    def winners(self):
        """(depth (H, W) float32, +inf empty; id (H, W) int64, -1 empty)."""
        hit = self.keys != EMPTY
        bits = (self.keys >> 32).to(torch.int32)
        depth = torch.where(hit, bits.view(torch.float32),
                            torch.full_like(bits.view(torch.float32),
                                            float("inf")))
        ids = torch.where(hit, self.keys & 0xFFFFFFFF,
                          torch.full_like(self.keys, -1))
        shape = (self.height, self.width)
        return depth.reshape(shape), ids.reshape(shape)
