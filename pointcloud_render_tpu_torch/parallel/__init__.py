"""Rendering beyond one frame's soup on one device: the chunked stream
(``streaming.StreamingRasterizer``).  The JAX package's device mesh
(``render_parallel``, ``multihost``) is not ported yet (ROADMAP A15)."""
