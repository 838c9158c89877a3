"""Layers and activations of the port (counterpart of ``repro.nn``)."""
