"""The benchmark's plain reference (NumPy only; imports nothing of the
program)."""
