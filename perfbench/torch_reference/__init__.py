"""The benchmark's plain references in torch, for comparisons made on
the card (torch and NumPy only; imports nothing of the program).
`perfbench/reference/` holds the NumPy ones."""
