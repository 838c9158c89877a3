"""Distributed training of the port (counterpart of ``repro.distributed``):
fault tolerance, fault injection and the actor/learner fleet are ported;
sharding (``distributed/sharding.py``) is not yet."""
