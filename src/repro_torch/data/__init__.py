"""The token data pipeline of the port (counterpart of ``repro.data``)."""
