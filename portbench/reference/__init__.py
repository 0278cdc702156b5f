"""The benchmark's plain reference: frozen copies of the port's plain
PyTorch paths (the DP, the min-BPP masks, the factors, the objective, the
scanner's posteriors, the CYK tables and traceback, Adam), a Python copy
of the native k-let shuffle, and the drivers that follow a cell's timed
path (``train_ref``, ``scan_ref``).  Nothing here imports the port or
JAX."""
