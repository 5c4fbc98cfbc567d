"""PyTorch/CUDA port of the Trie of Rules query system.

Same subpackage layout as the JAX reference package ``repro``; this
package imports neither JAX nor ``repro``.  Its entry points run on CUDA
unless the caller passes ``device="cpu"``.
"""
