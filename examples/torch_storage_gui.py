"""Interactive storage-valuation GUI for Jupyter on storage_tpu_torch (the
PyTorch port): ``examples/storage_gui.py``'s inputs, files and widgets over
the port's ``three_factor_seasonal_value`` on a torch device.

The equivalent of the reference's ``samples/python/storage_gui.py``
(ipywidgets front-end), rebuilt on plain ipywidgets (no ipysheet): tabbed
input panels with an editable monthly forward-curve table and a ratchet
grid, CSV import/export of curves and JSON save/load of the full input set,
asynchronous runs with a live progress bar and cancellation, a logging
panel, and result tables/plots (NPVs, deltas, expected inventory, trigger
prices).  ``GuiInputs`` has the JAX GUI's fields and nothing more: a file
saved by either GUI loads in the other.  The device is an argument of
:func:`run_valuation` and :class:`StorageGui`, not an input.

Requires ipywidgets + matplotlib for the widgets (gated; the module degrades
to a scripted ``run_valuation()`` API without them).  In a notebook::

    from torch_storage_gui import StorageGui
    StorageGui(device="cuda").show()

Headless::

    python examples/torch_storage_gui.py [--device cuda]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import argparse
import csv
import json
import logging
from dataclasses import asdict, dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import pandas as pd

from storage_tpu_torch import CmdtyStorage, RatchetInterp, three_factor_seasonal_value
from storage_tpu_torch.runtime import AsyncValuation

try:  # pragma: no cover - notebook-only dependency
    import ipywidgets as widgets
    from IPython.display import display

    HAVE_WIDGETS = True
except ImportError:  # pragma: no cover
    HAVE_WIDGETS = False


TEST_FWD_POINTS: List[Tuple[str, float]] = [
    ("2022-04", 16.61), ("2022-05", 15.68), ("2022-06", 15.42),
    ("2022-07", 15.31), ("2022-08", 15.27), ("2022-09", 15.13),
    ("2022-10", 15.96), ("2022-11", 17.22), ("2022-12", 17.32),
    ("2023-01", 17.66), ("2023-02", 17.59), ("2023-03", 16.81),
    ("2023-04", 15.36),
]
TEST_RATCHET_ROWS: List[Tuple[str, float, float, float]] = [
    # (date — blank continues the previous table, inventory, inject, withdraw)
    ("2022-04-01", 0.0, 250.0, -150.0),
    ("", 2000.0, 175.0, -200.0),
    ("", 5000.0, 155.0, -260.0),
    ("", 7000.0, 132.0, -275.0),
    ("2022-10-01", 0.0, 260.0, -130.0),
    ("", 2000.0, 190.0, -190.0),
    ("", 5000.0, 165.0, -230.0),
    ("", 7000.0, 148.0, -245.0),
]


@dataclass
class GuiInputs:
    """All GUI inputs; round-trips to JSON like the reference GUI's
    save/load val-data buttons (curves have their own CSV round-trip)."""

    storage_start: str = "2022-04-01"
    storage_end: str = "2023-04-01"
    injection_cost: float = 0.01
    withdrawal_cost: float = 0.025
    min_inventory: float = 0.0
    max_inventory: float = 1500.0
    max_injection_rate: float = 25.5
    max_withdrawal_rate: float = 30.9
    use_ratchets: bool = False
    ratchet_rows: List[Tuple[str, float, float, float]] = field(default_factory=list)
    val_date: str = "2022-04-01"
    inventory: float = 300.0
    flat_rate: float = 0.01
    spot_mean_reversion: float = 91.0
    spot_vol: float = 0.85
    long_term_vol: float = 0.30
    seasonal_vol: float = 0.19
    num_sims: int = 2000
    seed: int = 12
    basis_funcs: str = (
        "1 + x_st + x_sw + x_lt + s + x_st**2 + x_sw**2 + x_lt**2 + s**2 + s * x_st"
    )
    # Monthly (or any-period) forward pillars; resampled daily with ffill.
    fwd_points: List[Tuple[str, float]] = field(default_factory=list)

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(asdict(self), fh, indent=2)

    @classmethod
    def load(cls, path: str) -> "GuiInputs":
        with open(path) as fh:
            data = json.load(fh)
        data["fwd_points"] = [tuple(p) for p in data.get("fwd_points", [])]
        data["ratchet_rows"] = [tuple(r) for r in data.get("ratchet_rows", [])]
        return cls(**data)

    # ---- curves ---------------------------------------------------------- #

    def forward_curve(self) -> pd.Series:
        """Daily forward curve from the pillar table (ffill), or a synthetic
        seasonal curve when the table is empty."""
        if self.fwd_points:
            idx = pd.PeriodIndex([p for p, _ in self.fwd_points], freq="M")
            monthly = pd.Series([float(v) for _, v in self.fwd_points], index=idx)
            daily = monthly.resample("D").ffill()
            return daily[daily.index >= pd.Period(self.val_date, "D")]
        idx = pd.period_range(self.val_date, self.storage_end, freq="D")
        seasonal = 16.0 + 2.0 * np.sin(2 * np.pi * np.arange(len(idx)) / 365.0 + 1.0)
        return pd.Series(seasonal, index=idx)

    def save_fwd_csv(self, path: str) -> None:
        """Export the pillar table (reference: ``on_export_fwd_curve_clicked``:
        columns ``contract_start, price``)."""
        with open(path, "w", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=["contract_start", "price"])
            writer.writeheader()
            for period, price in self.fwd_points:
                writer.writerow({"contract_start": period, "price": price})

    def load_fwd_csv(self, path: str) -> None:
        """Import a pillar table (reference: ``on_import_fwd_curve_clicked``)."""
        with open(path) as fh:
            reader = csv.DictReader(fh)
            self.fwd_points = [
                (row["contract_start"], float(row["price"])) for row in reader
            ]

    def save_daily_fwd_csv(self, path: str) -> None:
        """Export the computed daily curve (reference:
        ``on_export_daily_fwd_clicked``)."""
        self.forward_curve().to_csv(path, index_label="date", header=["price"])

    # ---- ratchets -------------------------------------------------------- #

    def ratchets(self):
        """Ratchet rows -> the ``CmdtyStorage(ratchets=...)`` structure.

        Rows with a blank date extend the previous date's table (reference:
        ``read_ratchets``/``enumerate_ratchets``)."""
        tables = []
        for date, inv, inj, wdr in self.ratchet_rows:
            if str(date).strip():
                tables.append((str(date).strip(), []))
            if not tables:
                raise ValueError("First ratchet row must carry a date.")
            # CmdtyStorage convention: (inventory, withdraw_rate<0, inject_rate>0)
            tables[-1][1].append((float(inv), float(wdr), float(inj)))
        return tables

    def build_storage(self) -> CmdtyStorage:
        kwargs = dict(
            freq="D",
            storage_start=self.storage_start,
            storage_end=self.storage_end,
            injection_cost=self.injection_cost,
            withdrawal_cost=self.withdrawal_cost,
        )
        if self.use_ratchets and self.ratchet_rows:
            kwargs.update(
                ratchets=self.ratchets(), ratchet_interp=RatchetInterp.LINEAR
            )
        else:
            kwargs.update(
                min_inventory=self.min_inventory,
                max_inventory=self.max_inventory,
                max_injection_rate=self.max_injection_rate,
                max_withdrawal_rate=self.max_withdrawal_rate,
            )
        return CmdtyStorage(**kwargs)


def test_data_inputs() -> GuiInputs:
    """The reference GUI's 'test data' button payload."""
    return GuiInputs(
        use_ratchets=True,
        ratchet_rows=list(TEST_RATCHET_ROWS),
        fwd_points=list(TEST_FWD_POINTS),
        inventory=1500.0,
    )


def valuation_kwargs(inputs: GuiInputs) -> dict:
    """The keyword arguments of ``three_factor_seasonal_value`` for ``inputs``
    (without the hooks and the device)."""
    fwd = inputs.forward_curve()
    rates = pd.Series(
        inputs.flat_rate,
        index=pd.period_range(inputs.val_date, fwd.index[-1] + 60, freq="D"),
    )
    return dict(
        cmdty_storage=inputs.build_storage(),
        val_date=inputs.val_date,
        inventory=inputs.inventory,
        fwd_curve=fwd,
        interest_rates=rates,
        settlement_rule=lambda d: d.asfreq("M").asfreq("D", "end") + 20,
        spot_mean_reversion=inputs.spot_mean_reversion,
        spot_vol=inputs.spot_vol,
        long_term_vol=inputs.long_term_vol,
        seasonal_vol=inputs.seasonal_vol,
        num_sims=inputs.num_sims,
        seed=inputs.seed,
        basis_funcs=inputs.basis_funcs,
        discount_deltas=True,
    )


def run_valuation(inputs: GuiInputs, on_progress=None, cancelled=None, device="cuda"):
    """Scripted entry point used by the GUI (and usable headless), on the
    torch ``device``; per-sim panels on, as the API's default."""
    return three_factor_seasonal_value(
        **valuation_kwargs(inputs),
        on_progress_update=on_progress,
        cancelled=cancelled,
        device=device,
    )


def valuation_task(inputs: GuiInputs, device="cuda") -> AsyncValuation:
    """The background valuation the GUI's Calculate button starts, not yet
    started: subscribe to its progress and status, then ``start()`` it."""
    return AsyncValuation(three_factor_seasonal_value, **valuation_kwargs(inputs), device=device)


if HAVE_WIDGETS:  # pragma: no cover - interactive widget shells

    class _OutputLogHandler(logging.Handler):
        """logging.Handler rendering into an Output widget (reference:
        ``OutputWidgetHandler``)."""

        def __init__(self):
            super().__init__()
            self.out = widgets.Output(
                layout={"border": "1px solid #ccc", "max_height": "260px",
                        "overflow": "auto"}
            )
            self.setFormatter(
                logging.Formatter("%(asctime)s [%(levelname)s] %(message)s")
            )

        def emit(self, record):
            with self.out:
                print(self.format(record))

        def clear(self):
            self.out.clear_output()

    class _RowTable:
        """A small editable grid: one HBox of input widgets per row, with
        add/delete-row buttons (ipysheet replacement)."""

        def __init__(self, columns, make_widget, initial_rows):
            self.columns = columns
            self._make_widget = make_widget
            self.box = widgets.VBox()
            header = widgets.HBox(
                [widgets.HTML(f"<b>{c}</b>", layout={"width": "140px"})
                 for c in columns]
            )
            self._rows_box = widgets.VBox()
            add_btn = widgets.Button(description="+ row", layout={"width": "80px"})
            del_btn = widgets.Button(description="- row", layout={"width": "80px"})
            add_btn.on_click(lambda _b: self.append_row())
            del_btn.on_click(lambda _b: self.pop_row())
            self.box.children = [
                header, self._rows_box, widgets.HBox([add_btn, del_btn]),
            ]
            self.set_rows(initial_rows)

        def set_rows(self, rows):
            self._rows_box.children = [
                widgets.HBox([
                    self._make_widget(c, v)
                    for c, v in zip(self.columns, row)
                ])
                for row in rows
            ]

        def append_row(self):
            last = self.rows()[-1] if self.rows() else None
            blank = tuple(
                "" if isinstance(v, str) else 0.0 for v in (last or self.columns)
            )
            self.set_rows(self.rows() + [blank])

        def pop_row(self):
            rows = self.rows()
            if rows:
                self.set_rows(rows[:-1])

        def rows(self):
            return [
                tuple(w.value for w in hbox.children)
                for hbox in self._rows_box.children
            ]

    def _text(value, width="140px"):
        return widgets.Text(value=str(value), layout={"width": width})

    def _num(value, width="140px"):
        return widgets.FloatText(value=float(value or 0.0), layout={"width": width})

    class StorageGui:
        """Tabbed ipywidgets shell around :func:`run_valuation` on ``device``."""

        SCALARS = (
            "injection_cost", "withdrawal_cost", "min_inventory", "max_inventory",
            "max_injection_rate", "max_withdrawal_rate", "inventory", "flat_rate",
            "spot_mean_reversion", "spot_vol", "long_term_vol", "seasonal_vol",
        )
        TEXTS = ("storage_start", "storage_end", "val_date", "basis_funcs")

        def __init__(self, inputs: Optional[GuiInputs] = None, device="cuda"):
            self.inputs = inputs or GuiInputs()
            self.device = device
            self.task: Optional[AsyncValuation] = None
            self.results = None
            i = self.inputs
            style = {"description_width": "160px"}
            self._fields = {
                name: widgets.FloatText(value=getattr(i, name), description=name,
                                        style=style)
                for name in self.SCALARS
            }
            self._fields["num_sims"] = widgets.IntText(
                value=i.num_sims, description="num_sims", style=style)
            self._fields["seed"] = widgets.IntText(
                value=i.seed, description="seed", style=style)
            for name in self.TEXTS:
                self._fields[name] = widgets.Text(
                    value=getattr(i, name), description=name, style=style,
                    layout={"width": "560px"})
            self._use_ratchets = widgets.Checkbox(
                value=i.use_ratchets, description="use ratchet table", style=style)

            self._fwd_table = _RowTable(
                ("contract (YYYY-MM)", "price"),
                lambda c, v: _text(v) if "contract" in c else _num(v),
                i.fwd_points or TEST_FWD_POINTS,
            )
            self._ratchet_table = _RowTable(
                ("date (blank=cont.)", "inventory", "inject_rate", "withdraw_rate"),
                lambda c, v: _text(v) if "date" in c else _num(v),
                i.ratchet_rows or TEST_RATCHET_ROWS,
            )

            self._progress = widgets.FloatProgress(min=0.0, max=1.0,
                                                   description="progress")
            self._status = widgets.Label(value="idle")
            self._run_btn = widgets.Button(description="Calculate",
                                           button_style="primary")
            self._cancel_btn = widgets.Button(description="Cancel")
            self._test_btn = widgets.Button(description="Load test data")
            self._out = widgets.Output()
            self._plot_out = widgets.Output()
            self._run_btn.on_click(self._on_run)
            self._cancel_btn.on_click(lambda _b: self.task and self.task.cancel())
            self._test_btn.on_click(self._on_test_data)

            # CSV/JSON round-trip controls.
            self._path_box = widgets.Text(
                value="gui_inputs.json", description="path", style=style,
                layout={"width": "420px"})
            self._save_btn = widgets.Button(description="Save inputs")
            self._load_btn = widgets.Button(description="Load inputs")
            self._fwd_export_btn = widgets.Button(description="Export curve CSV")
            self._fwd_import_btn = widgets.Button(description="Import curve CSV")
            self._fwd_daily_btn = widgets.Button(description="Export daily CSV")
            self._fwd_plot_btn = widgets.Button(description="Plot curve")
            for btn, fn in (
                (self._save_btn, self._on_save), (self._load_btn, self._on_load),
                (self._fwd_export_btn, self._on_fwd_export),
                (self._fwd_import_btn, self._on_fwd_import),
                (self._fwd_daily_btn, self._on_fwd_daily),
                (self._fwd_plot_btn, self._on_fwd_plot),
            ):
                btn.on_click(fn)

            # Logging panel.
            self._log_handler = _OutputLogHandler()
            self._log_level = widgets.Dropdown(
                options=["DEBUG", "INFO", "WARNING", "ERROR"], value="INFO",
                description="log level")
            self._log_clear = widgets.Button(description="Clear logs")
            self._log_level.observe(self._on_log_level, names="value")
            self._log_clear.on_click(lambda _b: self._log_handler.clear())
            logger = logging.getLogger("storage_tpu_torch")
            logger.addHandler(self._log_handler)
            logger.setLevel(logging.INFO)

        # ---- collect / distribute ---------------------------------------- #

        def _collect(self) -> GuiInputs:
            values = {name: w.value for name, w in self._fields.items()}
            values["use_ratchets"] = self._use_ratchets.value
            values["fwd_points"] = [
                (p, float(v)) for p, v in self._fwd_table.rows() if str(p).strip()
            ]
            values["ratchet_rows"] = self._ratchet_table.rows()
            return GuiInputs(**{**asdict(self.inputs), **values})

        def _distribute(self, inputs: GuiInputs) -> None:
            self.inputs = inputs
            for name, w in self._fields.items():
                w.value = getattr(inputs, name)
            self._use_ratchets.value = inputs.use_ratchets
            if inputs.fwd_points:
                self._fwd_table.set_rows(inputs.fwd_points)
            if inputs.ratchet_rows:
                self._ratchet_table.set_rows(inputs.ratchet_rows)

        # ---- button handlers --------------------------------------------- #

        def _on_test_data(self, _b):
            self._distribute(test_data_inputs())

        def _on_save(self, _b):
            self._collect().save(self._path_box.value)
            self._status.value = f"inputs saved to {self._path_box.value}"

        def _on_load(self, _b):
            self._distribute(GuiInputs.load(self._path_box.value))
            self._status.value = f"inputs loaded from {self._path_box.value}"

        def _on_fwd_export(self, _b):
            self._collect().save_fwd_csv(self._path_box.value)
            self._status.value = f"curve pillars -> {self._path_box.value}"

        def _on_fwd_import(self, _b):
            inputs = self._collect()
            inputs.load_fwd_csv(self._path_box.value)
            self._distribute(inputs)
            self._status.value = f"curve pillars <- {self._path_box.value}"

        def _on_fwd_daily(self, _b):
            self._collect().save_daily_fwd_csv(self._path_box.value)
            self._status.value = f"daily curve -> {self._path_box.value}"

        def _on_fwd_plot(self, _b):
            with self._plot_out:
                self._plot_out.clear_output()
                import matplotlib.pyplot as plt

                self._collect().forward_curve().plot(
                    figsize=(8, 2.5), title="Daily forward curve")
                plt.tight_layout()
                plt.show()

        def _on_log_level(self, change):
            logging.getLogger("storage_tpu_torch").setLevel(change["new"])

        def _on_run(self, _button):
            self.task = valuation_task(self._collect(), self.device)
            self.task.subscribe_progress(
                lambda p: setattr(self._progress, "value", p))
            self.task.subscribe_status(
                lambda s: setattr(self._status, "value", s.value))
            self.task.start()
            import threading

            threading.Thread(target=self._render_results, daemon=True).start()

        def _render_results(self):
            try:
                results = self.task.result()
            except Exception as exc:  # noqa: BLE001
                with self._out:
                    print(f"error: {exc}")
                return
            self.results = results
            with self._out:
                self._out.clear_output()
                print(f"Full NPV:      {results.npv:,.0f}")
                print(f"Intrinsic NPV: {results.intrinsic_npv:,.0f}")
                print(f"Extrinsic NPV: {results.extrinsic_npv:,.0f}")
                print("\nDeltas (head):")
                print(results.deltas.head(10))
                print("\nTrigger prices (head):")
                print(results.trigger_prices.dropna().head(10))
                try:
                    import matplotlib.pyplot as plt

                    fig, axes = plt.subplots(1, 3, figsize=(13, 3))
                    results.deltas.plot(ax=axes[0], title="Deltas")
                    results.expected_profile["inventory"].plot(
                        ax=axes[1], title="Expected inventory")
                    tp = results.trigger_prices
                    tp["inject_trigger_price"].plot(ax=axes[2], label="inject")
                    tp["withdraw_trigger_price"].plot(ax=axes[2], label="withdraw")
                    axes[2].set_title("Trigger prices")
                    axes[2].legend()
                    plt.tight_layout()
                    plt.show()
                except ImportError:
                    pass

        # ---- layout ------------------------------------------------------- #

        def show(self):
            val_tab = widgets.VBox(
                [self._fields[n] for n in
                 ("val_date", "inventory", "flat_rate", "num_sims", "seed",
                  "basis_funcs")]
                + [widgets.HBox([self._path_box]),
                   widgets.HBox([self._save_btn, self._load_btn, self._test_btn])]
            )
            fwd_tab = widgets.VBox([
                self._fwd_table.box,
                widgets.HBox([self._fwd_import_btn, self._fwd_export_btn,
                              self._fwd_daily_btn, self._fwd_plot_btn]),
                self._plot_out,
            ])
            storage_tab = widgets.VBox(
                [self._fields[n] for n in
                 ("storage_start", "storage_end", "injection_cost",
                  "withdrawal_cost", "min_inventory", "max_inventory",
                  "max_injection_rate", "max_withdrawal_rate")]
                + [self._use_ratchets, self._ratchet_table.box]
            )
            model_tab = widgets.VBox(
                [self._fields[n] for n in
                 ("spot_mean_reversion", "spot_vol", "long_term_vol",
                  "seasonal_vol")]
            )
            results_tab = widgets.VBox([self._out])
            logs_tab = widgets.VBox(
                [widgets.HBox([self._log_level, self._log_clear]),
                 self._log_handler.out]
            )
            tabs = widgets.Tab(
                children=[val_tab, fwd_tab, storage_tab, model_tab, results_tab,
                          logs_tab]
            )
            for k, title in enumerate(
                ("Valuation", "Forward curve", "Storage", "Model", "Results",
                 "Logs")
            ):
                tabs.set_title(k, title)
            display(
                widgets.VBox([
                    tabs,
                    widgets.HBox([self._run_btn, self._cancel_btn,
                                  self._progress, self._status]),
                ])
            )

else:  # pragma: no cover

    class StorageGui:  # type: ignore[no-redef]
        def __init__(self, *a, **k):
            raise ImportError(
                "ipywidgets is required for the interactive GUI; "
                "use run_valuation(GuiInputs(...)) headless instead."
            )


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args()
    results = run_valuation(test_data_inputs(), device=args.device)
    print(f"Full NPV: {results.npv:,.0f}  Intrinsic: {results.intrinsic_npv:,.0f}")
