"""The plain reference of every cell, in plain PyTorch, and its lower-precision control.

It imports nothing of the port: it works out the statistics, the
factors, the ADMM solves, the debias and the serving runtime's
refits again from the inputs the benchmark hands it.  Every
matrix product goes through an ``mm`` argument: :func:`precision.mm`
is float32 with TF32 off (the configurations' precision), and
:func:`precision.mm_tf32` rounds both operands to TF32 first, the
control that a correct run has to tell apart from the reference.
"""
