"""RL algorithms of the port (counterpart of ``repro.rl``)."""
