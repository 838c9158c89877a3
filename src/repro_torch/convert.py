"""Carry weights and states across from the JAX package (no counterpart
there).

The JAX package's parameter pytrees are nested dicts of arrays; given as
numpy arrays (or anything ``np.asarray`` accepts), they become the port's
nested dicts of tensors. Layouts are the same on both sides (dense ``w``
(in, out), GRU gate-major ``[r|z|n]``, stacked (A, ...) per-agent AIPs),
so this is a dtype- and device-aware copy, never a transpose. uint32
random bits become their int32 storage, bool and int8 leaves keep their
dtype; bfloat16 and float16 keep theirs, float32 and float64 become
float32.

``to_torch`` covers the AIP (GRU and FNN, single and (A, ...) stacked),
the policy, and the LS, GS, IALS and rollout states: NamedTuple states
(``LocalTrafficState``, ``TrafficState``, ``LocalWarehouseState``,
``WarehouseState``, ``IALSState``, ``MultiIALSState``, ``RolloutState``)
are rebuilt as the port's classes of the same name, batched or scalar
(a scalar state's 0-d leaves stay 0-d), so the JAX scalar envs' states
carry across into the port's scalar envs. The LM's parameters and caches
carry across too: its recurrent states (``MambaState``, ``MLSTMState``,
``SLSTMState``) become the port's ``repro_torch/nn/ssm.py`` classes, and
an optimizer state (``AdamWState``: step, ``mu``, ``nu``) becomes the
port's, its 0-d int32 ``step`` on the host as the port keeps it, so a
JAX LM training state ``{"params", "opt"}`` resumes in the port.
This module never imports the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.engine import IALSState
from repro_torch.core.ials import MultiIALSState
from repro_torch.envs.traffic import LocalTrafficState, TrafficState
from repro_torch.envs.warehouse import LocalWarehouseState, WarehouseState
from repro_torch.nn.ssm import MambaState, MLSTMState, SLSTMState
from repro_torch.optim.adamw import AdamWState
from repro_torch.rl.ppo import RolloutState

_STATES = {cls.__name__: cls for cls in
           (LocalTrafficState, TrafficState, LocalWarehouseState,
            WarehouseState, IALSState, MultiIALSState, RolloutState,
            MambaState, MLSTMState, SLSTMState, AdamWState)}


def array_to_torch(x, device="cuda") -> torch.Tensor:
    a = np.asarray(x)
    dtype = None
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype.name == "bfloat16":   # ml_dtypes: numpy has no bfloat16
        a, dtype = a.astype(np.float32), torch.bfloat16   # exact
    elif a.dtype.kind == "f" and a.dtype != np.float16:
        a = a.astype(np.float32)
    t = torch.from_numpy(np.array(a, copy=True, order="C"))
    return t.to(resolve_device(device), dtype=dtype)


def to_torch(tree, device="cuda"):
    """A JAX-side pytree (dicts, lists, tuples, NamedTuples of arrays;
    ``None`` kept) -> the port's pytree of tensors on ``device``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = _STATES.get(type(tree).__name__)
        vals = [to_torch(v, "cpu" if cls is AdamWState and i == 0
                         else device) for i, v in enumerate(tree)]
        return cls(*vals) if cls is not None else tuple(vals)
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    return array_to_torch(tree, device)

