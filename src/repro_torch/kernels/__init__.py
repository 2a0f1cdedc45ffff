"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Nothing is compiled at import: ``_build.library()`` runs ``nvcc`` at the
first launch on a CUDA tensor."""
