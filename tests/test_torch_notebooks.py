"""``examples/_make_torch_notebooks.py`` and the three ``examples/torch_*.ipynb``.

- The generator writes the three notebooks into a fresh folder, equal byte
  for byte to the committed ones (fixed cell ids, no outputs), and no code
  cell imports JAX or the JAX package.
- The cells a headless run leaves out are tagged: ``StorageGui().show()``
  ``needs-ipywidgets``, every plotting cell ``needs-matplotlib``; a notebook
  that values starts with its ``parameters`` cell, ``DEVICE = "cuda"``.
- ``nbclient`` executes each notebook with ``DEVICE = "cpu"`` in a kernel
  started in ``examples/`` (every cell here: ipywidgets and matplotlib
  import), and the valuing ones print their NPVs (~45 s for the three).
- ``chip_smoke.run_notebook``, the card's way of running them (code cells in
  one namespace, read with ``json``), on the CPU: it leaves out exactly the
  cells whose module does not import, and ``chip_smoke``'s recording keeps
  the first valuation's launches that its ``notebooks`` phase holds
  against the plain versions.
"""
import importlib.util
import json
import re
import sys
import threading
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"
sys.path[:0] = [str(REPO), str(EXAMPLES)]

import _make_torch_notebooks as make  # noqa: E402
import chip_smoke  # noqa: E402

TIMEOUT_S = 600


def _code_cells(path):
    return [c for c in json.loads(Path(path).read_text())["cells"] if c["cell_type"] == "code"]


def _tags(cell):
    return cell.get("metadata", {}).get("tags", [])


def test_generator_writes_the_committed_notebooks(tmp_path):
    make.main(str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(make.NOTEBOOKS)
    assert tuple(make.NOTEBOOKS) == chip_smoke.NOTEBOOKS
    for name in make.NOTEBOOKS:
        assert (tmp_path / name).read_bytes() == (EXAMPLES / name).read_bytes(), name
        for cell in _code_cells(tmp_path / name):
            source = "".join(cell["source"])
            assert not re.search(r"^\s*(import|from)\s+(jax|storage_tpu)\b(?!_torch)", source,
                                 re.MULTILINE), source
            assert cell["outputs"] == [] and cell["execution_count"] is None


def test_cells_are_tagged_for_a_headless_run():
    for name in make.NOTEBOOKS:
        cells = _code_cells(EXAMPLES / name)
        values = any("DEVICE" in "".join(c["source"]) for c in cells)
        params = [c for c in cells if "parameters" in _tags(c)]
        assert len(params) == (1 if values else 0), name
        if values:
            assert cells[0] is params[0] and "".join(params[0]["source"]).startswith(
                'DEVICE = "cuda"')
        for cell in cells:
            source = "".join(cell["source"])
            assert ("plt." in source) == ("needs-matplotlib" in _tags(cell)), source
            assert ("gui.show()" in source) == ("needs-ipywidgets" in _tags(cell)), source


class _Nudger:
    """Sends the kernel a ``kernel_info_request`` every ``EVERY_S`` seconds
    from a second client while a notebook runs.  Under a loaded test run one
    kernel (ipykernel 7) once sat idle with every cell run while nbclient
    still waited for its reply, until another client's request reached the
    kernel; a request every few seconds lets such a reply out.  The second
    client reads nothing, and nbclient ignores messages of other requests."""

    EVERY_S = 5.0

    def __init__(self):
        self.done, self.kc, self.thread = threading.Event(), None, None

    def start(self, km):
        from jupyter_client import BlockingKernelClient

        self.kc = BlockingKernelClient()
        self.kc.load_connection_info(km.get_connection_info())
        self.kc.start_channels(iopub=False, stdin=False, hb=False, control=False)
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while not self.done.wait(self.EVERY_S):
            self.kc.kernel_info()

    def stop(self):
        self.done.set()
        if self.thread is not None:
            self.thread.join()
            self.kc.stop_channels()


@pytest.mark.parametrize("name", make.NOTEBOOKS)
def test_notebook_executes_on_the_cpu(name, monkeypatch):
    import nbformat
    from nbclient import NotebookClient

    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    nb = nbformat.read(EXAMPLES / name, as_version=4)
    for cell in nb.cells:
        if "parameters" in cell.metadata.get("tags", []):
            cell.source = 'DEVICE = "cpu"'
    client = NotebookClient(nb, timeout=TIMEOUT_S, kernel_name="python3",
                            resources={"metadata": {"path": str(EXAMPLES)}})
    nudger = _Nudger()
    client.on_notebook_start = lambda notebook: nudger.start(client.km)
    try:
        client.execute()
    finally:
        nudger.stop()
    printed = "".join(out.get("text", "") for cell in nb.cells if cell.cell_type == "code"
                      for out in cell.outputs if out.output_type == "stream")
    if name != "torch_creating_storage_instances.ipynb":
        assert re.search(r"Full NPV:\s+[\d,]+", printed), printed
    if name == "torch_storage_valuation_walkthrough.ipynb":
        for label in ("Intrinsic :", "Trinomial :", "LSMC      :"):
            assert label in printed


def test_smoke_runner_leaves_out_what_does_not_import(monkeypatch):
    path = str(EXAMPLES / "torch_storage_valuation_walkthrough.ipynb")
    sources, left_out = chip_smoke.notebook_cells(path, "cpu")
    assert left_out == [] and sources[0] == "DEVICE = 'cpu'"
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else real(name, *a))
    fewer, left_out = chip_smoke.notebook_cells(path, "cpu")
    assert left_out == ["needs-matplotlib"] * 2 and len(fewer) == len(sources) - 2
    assert not any("plt." in s for s in fewer)


def test_smoke_runner_runs_a_notebook():
    namespace, printed, left_out = chip_smoke.run_notebook(
        str(EXAMPLES / "torch_creating_storage_instances.ipynb"), "cpu")
    assert left_out == [] and "must be empty at end: False" in printed
    assert namespace["hourly"].start.freqstr.lower() == "h"


def test_smoke_records_the_first_valuation():
    rec = chip_smoke._recording(
        chip_smoke._first_launches(chip_smoke.NOTEBOOK_CAPTURE_LAUNCH, ("float32",)))
    with rec:
        namespace, _, _ = chip_smoke.run_notebook(
            str(EXAMPLES / "torch_storage_valuation_walkthrough.ipynb"), "cpu")
    n_steps = len(namespace["results"].expected_profile) - 1
    assert rec.calls == {("K1", "float32"): n_steps - 1, ("K2", "float32"): 1,
                         ("K3", "float32"): 2}
    assert chip_smoke.NOTEBOOK_CAPTURE_LAUNCH == (n_steps - 1) // 2
    assert sorted(rec.recorded) == [("K1", "float32"), ("K2", "float32"), ("K3", "float32")]
    coeffs, num_sims, key, antithetic = rec.recorded[("K3", "float32")]
    assert num_sims == 2000 and coeffs.decay.shape[0] == n_steps
