"""DSP primitives and the kernel wrappers (zc, refine, OLA)."""
