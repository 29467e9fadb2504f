"""PyTorch / CUDA port of the ADPSGD reproduction (``src/repro`` is the JAX
reference).

The layout mirrors the reference: ``repro_torch/<subpkg>/<file>.py`` ports
``repro/<subpkg>/<file>.py``.  Parameters are nested dicts/lists of tensors
with the reference's layout (dense ``w`` is ``(d_in, d_out)``), so
``interop.params_from_numpy`` moves a reference pytree across with no
transposes.  Entry points run on CUDA unless the caller passes
``device="cpu"``; the fused sync kernel (``kernels/csrc/mean_sqdev.cu``)
runs on every sync whose parameters live on the card.
"""
