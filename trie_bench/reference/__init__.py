"""The plain reference: mines the generated database itself and answers the
served queries from its own structure.  Plain PyTorch and NumPy; it
imports nothing of ``repro_torch``, ``repro`` or JAX, and takes nothing
that the program made.
"""
