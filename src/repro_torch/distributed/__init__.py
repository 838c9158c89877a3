"""Fault injection of the port (counterpart of ``repro.distributed``;
the actor/learner fleet and sharding are not ported yet)."""
