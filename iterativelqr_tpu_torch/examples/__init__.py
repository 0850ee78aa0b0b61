"""The JAX package's examples (``examples/*.py``) on the port, each
runnable as ``python -m iterativelqr_tpu_torch.examples.<name>`` with the
same problem, sizes and defaults, plus ``--device`` (default ``cuda``)."""
