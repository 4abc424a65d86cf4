"""Carry the JAX package's compiled state across to the port.

Both packages compile the same host-side ``ValuationContext`` and run the
same LSMC policy representation, so a test (or a user migrating a saved
policy) can hand the port exactly the state the JAX side produced.  This
module never imports the JAX package: it reads the objects' fields by name
and their arrays through ``numpy.asarray``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .compile import ValuationContext
from .engines.lsmc import LsmcPolicy
from .ops.inventory_space import InventorySpace

_CONTEXT_ARRAYS = (
    "grids", "pillars", "inject_cost", "withdraw_cost", "cons_inject", "cons_withdraw",
    "inventory_loss", "inventory_cost_rate", "df_settle", "df_cost", "fwd",
)


def context_from_numpy(ctx) -> ValuationContext:
    """The port's :class:`ValuationContext` with the fields of ``ctx`` (any
    object with the same field names, e.g. the JAX package's context).

    Arrays are copied as float64 NumPy arrays; the storage object is shared,
    since the engines only read its configuration (terminal value function,
    pillar tables, start period)."""
    arrays = {name: np.array(getattr(ctx, name), dtype=np.float64) for name in _CONTEXT_ARRAYS}
    return ValuationContext(
        storage=ctx.storage,
        freq=ctx.freq,
        val_period=ctx.val_period,
        periods=ctx.periods,
        n_steps=int(ctx.n_steps),
        val_date_is_first_step=bool(ctx.val_date_is_first_step),
        inventory=float(ctx.inventory),
        inv_space=InventorySpace(
            min_inventory=np.array(ctx.inv_space.min_inventory, dtype=np.float64),
            max_inventory=np.array(ctx.inv_space.max_inventory, dtype=np.float64),
        ),
        num_grid_points=int(ctx.num_grid_points),
        interp_kind=int(ctx.interp_kind),
        numerical_tolerance=float(ctx.numerical_tolerance),
        **arrays,
    )


def lsmc_policy_from_numpy(policy, device="cuda", dtype=torch.float32) -> LsmcPolicy:
    """The port's :class:`LsmcPolicy` (tensors of ``dtype`` on ``device``) from a fitted policy of either package: the path of an
    ``.npz`` written by ``LsmcPolicy.save``, a mapping of the six field names
    to arrays, or an object with those fields (the JAX package's
    ``LsmcPolicy``; anything ``numpy.asarray`` accepts per field)."""
    if isinstance(policy, (str, os.PathLike)):
        return LsmcPolicy.load(policy, device, dtype)
    return LsmcPolicy.from_numpy(policy, device, dtype)
