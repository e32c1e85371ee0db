"""astrophotography_tpu — an accelerator-native astronomical image-processing
framework.

A ground-up JAX/XLA rebuild of the capabilities of
DaveStrickland/AstroPhotography (reference: /root/reference): DSLR RAW
conversion (``dksraw``) and the full FITS reduction chain (the ``ap_*``
tools), with the compute core implemented as batched, jitted device
kernels rather than single-threaded numpy.

Public surface mirrors the reference package exports
(reference AstroPhotography/__init__.py:10-12 and core/__init__.py:6-34)
while the implementation is device-first.
"""

from .__version__ import __version__

__all__ = ["__version__"]
