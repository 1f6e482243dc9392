"""csr6_raster's share of its roofline at the flythrough's checked
frames (see ``_roofline``)."""

from portbench.metrics import _roofline

WALK = _roofline.walk_pattern(0, "kRows16")


def read(record):
    return _roofline.share(record, "csr6_raster", WALK)
