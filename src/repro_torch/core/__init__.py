"""Core IALS machinery of the port (counterpart of ``repro.core``)."""
