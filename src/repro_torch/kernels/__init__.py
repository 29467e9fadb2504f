"""Hand-written Hopper kernels of the port, one per Pallas kernel of the
reference on the ported path, each beside its plain version in ``ref.py``."""
