"""The benchmark's harness: what runs a cell, times it, reads its trace and
checks its output.  It imports the program under test (the PyTorch and
CUDA package) only inside the functions that drive it."""
