"""Models of the port (counterpart of ``repro.models``): ``lm.py``, the
unified LM assembled from an ``ArchConfig``."""
