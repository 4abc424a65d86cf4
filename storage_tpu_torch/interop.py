"""Carry the JAX package's compiled state across to the port.

Both packages compile the same host-side ``ValuationContext`` and run the
same LSMC policy representation, so a test (or a user migrating a saved
policy) can hand the port exactly the state the JAX side produced.  This
module never imports the JAX package: it reads the objects' fields by name
and their arrays through ``numpy.asarray``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .compile import ValuationContext
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


class ForwardPolicy(NamedTuple):
    """The regression policy the forward pass applies, per simulated step."""

    coeffs: torch.Tensor  # [m, B, G]
    mus: torch.Tensor  # [m, B]
    sds: torch.Tensor  # [m, B]
    vbars: torch.Tensor  # [m, G]


def lsmc_policy_from_numpy(coeffs, mus, sds, vbars, device=None) -> ForwardPolicy:
    """Float32 tensors on ``device`` from a backward pass's outputs (arrays of
    either package, or anything ``numpy.asarray`` accepts)."""

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)

    return ForwardPolicy(t(coeffs), t(mus), t(sds), t(vbars))
