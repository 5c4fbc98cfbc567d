"""The benchmark of the PyTorch and CUDA port (``repro_torch``): the Trie
of Rules served on one GPU under closed-loop analyst traffic.

``run.py`` is the entry point.  Everything that measures (the data and
traffic generators, the peaks and the roofline arithmetic, the reading of
the device trace, the plain reference and the comparison that decides
``correct``) lives in this folder; from the port it takes only the system
under test and its counters.  Nothing here imports ``jax``, ``jaxlib`` or
the JAX package ``repro``, and nothing under ``reference/`` imports
``repro_torch``.
"""
