"""The benchmark's plain reference: the tracer, the guides and the work
counters, in plain PyTorch and numpy.  Nothing here imports the program."""
