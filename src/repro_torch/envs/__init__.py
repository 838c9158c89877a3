"""Environments of the port (counterpart of ``repro.envs``)."""
