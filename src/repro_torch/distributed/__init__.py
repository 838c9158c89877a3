"""Distributed training of the port (counterpart of ``repro.distributed``):
fault tolerance, fault injection, the actor/learner fleet and the IALS
half of sharding (``distributed/sharding.py``: lane data parallelism over
``torch.distributed``). The LM half of sharding waits for the LM stack."""
