"""The general traffic generator: one caller in a closed loop, driving the
program's public entry points with the calls a traffic file describes.

A traffic file (``traffic/<mix>.json``) holds:

- ``entry``: ``"value"`` (``storage_tpu_torch.three_factor_seasonal_value``,
  a full valuation) or ``"reprice"`` (``engines.lsmc.fit_policy`` once in
  set-up on the run seed's regression set, then per call a fresh valuation
  set from ``simulate_factor_paths`` and ``engines.lsmc.reprice``);
- ``num_sims``; ``panels`` (per-sim panels returned); ``progress`` (a
  progress callback, which runs the chunked driver);
- ``trace_calls``: the calls a ``--trace 1`` run traces; ``check_calls``:
  the calls, drawn from the seed among those completed, that the reference
  recomputes.

Every call has a seed of its own (:func:`~portbench.cases.call_seed`); the
work of a call does not depend on the seed, only its random numbers do.
"""
from __future__ import annotations

import os
import random
import time
import traceback
from typing import Callable, Dict, List, Optional

import numpy as np

from .cases import call_seed, port_case

MAX_PATH_BYTES_ENV = "STORAGE_TPU_MAX_PATH_BYTES"


class Program:
    """The program set up for one cell: ``call(i)`` makes call ``i`` of the
    run and returns what it produced, on the host."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device="cuda",
                 num_sims: Optional[int] = None):
        import storage_tpu_torch as st
        import torch

        # The configuration's path budget, or the program's default.
        if cfg.get("max_path_bytes") is not None:
            os.environ[MAX_PATH_BYTES_ENV] = repr(float(cfg["max_path_bytes"]))
        else:
            os.environ.pop(MAX_PATH_BYTES_ENV, None)
        self.st = st
        self.cfg, self.mix, self.seed, self.device = cfg, mix, int(seed), device
        self.dtype = getattr(torch, cfg["dtype"])
        self.num_sims = int(num_sims or mix["num_sims"])
        self.kw = port_case(cfg)
        self.profile_sink: Optional[Callable] = None
        self.spans: List[tuple] = []  # (name, seconds) of the harness's own spans, traced runs
        self.span_sync = False
        if mix["entry"] == "reprice":
            self._fit()

    # -- the reprice desk's set-up: fit once on the run seed's regression set --
    def _fit(self):
        import torch
        from storage_tpu_torch.compile import build_valuation_context
        from storage_tpu_torch.engines.lsmc import fit_policy
        from storage_tpu_torch.models.multi_factor import (
            build_sim_coefficients, create_3_factor_season_params)
        from storage_tpu_torch.models.simulation import prng_key, simulate_factor_paths
        from storage_tpu_torch.ops.regression import basis_spec
        from storage_tpu_torch.utils.basis import THREE_FACTOR_SEASONAL_ALIASES, as_monomials

        kw, model = self.kw, self.cfg["model"]
        storage = kw["cmdty_storage"]
        self.ctx = build_valuation_context(
            storage, kw["val_date"], kw["inventory"], kw["fwd_curve"], kw["interest_rates"],
            kw["settlement_rule"], kw["num_inventory_grid_points"], 1e-12)
        factors, corrs = create_3_factor_season_params(
            self.cfg["freq"], model["spot_mean_reversion"], model["spot_vol"],
            model["long_term_vol"], model["seasonal_vol"], self.ctx.val_period, storage.end)
        self.coeffs = build_sim_coefficients(factors, corrs, self.ctx.val_period, kw["fwd_curve"],
                                             list(self.ctx.periods[1:]))
        self.spec = basis_spec(as_monomials(kw["basis_funcs"], THREE_FACTOR_SEASONAL_ALIASES),
                               num_factors=3)
        self._simulate = simulate_factor_paths
        self._prng_key = prng_key
        reg = simulate_factor_paths(self.coeffs, self.num_sims, key=prng_key(self.seed),
                                    antithetic=self.cfg["antithetic"], device=self.device,
                                    dtype=self.dtype)
        self.policy = fit_policy(self.ctx, reg, self.coeffs.vols, self.coeffs.log_fwd_drift,
                                 self.spec, device=self.device, dtype=self.dtype)
        del reg
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def _sync(self):
        import torch

        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def _span(self, name, fn):
        if not self.span_sync:
            return fn()
        self._sync()
        t0 = time.perf_counter()
        out = fn()
        self._sync()
        self.spans.append((name, time.perf_counter() - t0))
        return out

    def call(self, i: int) -> Dict[str, np.ndarray]:
        s = call_seed(self.seed, i)
        if self.mix["entry"] == "reprice":
            return self._reprice(s)
        return self._value(s)

    def _value(self, s: int) -> Dict[str, np.ndarray]:
        progress = [] if self.mix.get("progress") else None  # the add-in's callback
        res = self.st.three_factor_seasonal_value(
            **self.kw, num_sims=self.num_sims, seed=s, dtype=self.dtype, device=self.device,
            return_sim_panels=bool(self.mix.get("panels")),
            on_progress_update=progress.append if progress is not None else None,
            profile_sink=self.profile_sink)
        out = dict(npv=np.float64(res.npv), intrinsic_npv=np.float64(res.intrinsic_npv),
                   deltas=res.deltas.to_numpy(np.float64),
                   profile=res.expected_profile.to_numpy(np.float64),
                   triggers=res.trigger_prices.to_numpy(np.float64))
        if self.mix.get("panels"):
            out["spots_reg"] = res.sim_spot_regress.to_numpy(np.float64)
            out["spots_val"] = res.sim_spot_valuation.to_numpy(np.float64)
            out["panels"] = np.stack([f.to_numpy(np.float64) for f in (
                res.sim_inventory, res.sim_inject_withdraw, res.sim_cmdty_consumed,
                res.sim_inventory_loss, res.sim_net_volume, res.sim_pv)], axis=1)
        return out

    def _reprice(self, s: int) -> Dict[str, np.ndarray]:
        import torch
        from storage_tpu_torch.engines.lsmc import reprice

        val = self._span("path_sim", lambda: self._simulate(
            self.coeffs, self.num_sims, key=self._prng_key(s), antithetic=self.cfg["antithetic"],
            device=self.device, dtype=self.dtype))
        arrays = self._span("forward", lambda: reprice(
            self.ctx, self.policy, val, self.coeffs.vols, self.coeffs.log_fwd_drift, self.spec,
            discount_deltas=self.cfg["discount_deltas"], device=self.device, dtype=self.dtype))
        del val
        # The results on the host: one transfer of the small outputs, as the
        # valuation API makes it.
        small = [arrays.npv.reshape(1), arrays.deltas, arrays.profile_means.reshape(-1),
                 arrays.trigger_has_inject.to(arrays.npv.dtype),
                 arrays.trigger_inject_volumes[:, -1], arrays.trigger_inject_prices[:, -1],
                 arrays.trigger_has_withdraw.to(arrays.npv.dtype),
                 arrays.trigger_withdraw_volumes[:, -1], arrays.trigger_withdraw_prices[:, 0]]
        flat = torch.cat([a.reshape(-1) for a in small]).double().cpu().numpy()
        n1 = arrays.deltas.shape[0]
        n = n1 - 1
        npv, deltas, profile = flat[0], flat[1:1 + n1], flat[1 + n1:1 + 7 * n1].reshape(n1, 6)
        t = flat[1 + 7 * n1:].reshape(6, n)
        nan = np.nan
        triggers = np.stack([np.where(t[0] > 0.5, t[1], nan), np.where(t[0] > 0.5, t[2], nan),
                             np.where(t[3] > 0.5, t[4], nan), np.where(t[3] > 0.5, t[5], nan)],
                            axis=1)
        return dict(npv=np.float64(npv), deltas=deltas, profile=profile, triggers=triggers)


class Sample:
    """``k`` calls drawn uniformly, by the run seed, from all those completed
    (reservoir sampling: the count need not be known in advance)."""

    def __init__(self, seed: int, k: int):
        self.rng = random.Random(int(seed) ^ 0x5EED)
        self.k = max(1, int(k))
        self.items: List[tuple] = []
        self.seen = 0

    def offer(self, i: int, result) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append((i, result))
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = (i, result)


def closed_loop(program: Program, seconds: float, sample: Sample,
                max_calls: Optional[int] = None):
    """Calls 0, 1, ... back to back until ``seconds`` have passed (the last
    call finishes) or ``max_calls`` were made; a call that raises is counted
    as failed and the loop goes on.  Returns (latencies s, wall s, failed)."""
    lat, failed = [], 0
    t0 = time.perf_counter()
    while True:
        c0 = time.perf_counter()
        try:
            sample.offer(len(lat), program.call(len(lat)))
        except Exception:  # noqa: BLE001 - a failed call is counted, not fatal
            failed += 1
            traceback.print_exc()
        lat.append(time.perf_counter() - c0)
        if time.perf_counter() - t0 >= seconds or (max_calls and len(lat) >= max_calls):
            return lat, time.perf_counter() - t0, failed
