"""Plain models and seeded fixtures that the tests and chip_smoke.py hold
the kernels to; no render path imports them."""
