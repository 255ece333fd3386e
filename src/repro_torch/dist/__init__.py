"""Multi-device scheduling of the port (port of ``repro.dist``). Only the
crossbar-batch wave arithmetic (``batching``) is here yet: the PIM model
schedules its batches with it; the distributed tiers come with the
multi-device slice (ROADMAP queue 1, item 9)."""
