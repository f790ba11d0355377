"""The benchmark's plain reference: plain PyTorch and NumPy, importing
nothing of the program.  Whatever the program derives from the benchmark's
inputs (edges, bins, the packed model, trees) is worked out again here."""
