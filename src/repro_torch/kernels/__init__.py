"""Hand-written CUDA kernels for Hopper, each beside its plain version.

Importing these modules builds nothing: a kernel is compiled from
``csrc/`` at its first launch (``_build``)."""
