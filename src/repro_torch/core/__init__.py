"""Device placement and the mixed-precision policy."""
