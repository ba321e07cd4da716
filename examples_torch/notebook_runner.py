"""Run a notebook of examples_torch/notebooks/ without a Jupyter kernel.

``run_notebook(path, parameters=None, plots=None)`` reads the ``.ipynb`` as
plain JSON and runs its code cells in order in one namespace, with
``compile``/``exec``, so it needs neither nbformat nor nbclient nor
ipykernel. ``parameters`` overrides names of the cell tagged
``parameters``: as papermill does, an ``injected-parameters`` cell that
assigns them is put after that cell. Cells tagged ``plot`` only draw: with
``plots=None`` they run where matplotlib imports (on its Agg backend, every
figure closed after each cell) and are left out, with a printed count,
where it does not; ``plots=True`` requires them and ``plots=False`` leaves
them out. A cell that raises re-raises with the notebook's name and the
cell's index. Load it with ``runpy.run_path`` and call ``run_notebook``,
or run notebooks as they are (on the CUDA card) from the repository root,
each timed on the host's clock::

    PYTHONPATH=. python examples_torch/notebook_runner.py NOTEBOOK [NOTEBOOK ...]
"""

import ast
import importlib
import json
import pathlib
import sys
import time

PARAMETERS_TAG = "parameters"
INJECTED_TAG = "injected-parameters"
PLOT_TAG = "plot"


def read_notebook(path) -> dict:
    return json.loads(pathlib.Path(path).read_text(encoding="utf-8"))


def cell_source(cell: dict) -> str:
    src = cell["source"]
    return src if isinstance(src, str) else "".join(src)


def cell_tags(cell: dict) -> list:
    return cell.get("metadata", {}).get("tags", [])


def assigned_names(source: str) -> set:
    """The names a cell's top-level assignments bind."""
    names = set()
    for node in ast.parse(source).body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign) else [])
        for target in targets:
            names.update(n.id for n in ast.walk(target) if isinstance(n, ast.Name))
    return names


def inject_parameters(nb: dict, parameters: dict, name: str = "notebook") -> dict:
    """A copy of ``nb`` with an ``injected-parameters`` cell that assigns
    ``parameters`` put after its one ``parameters`` cell. Each name must be
    one that cell assigns, and each value a literal (it is written into the
    cell as its ``repr``)."""
    cells = nb["cells"]
    found = [i for i, c in enumerate(cells)
             if c["cell_type"] == "code" and PARAMETERS_TAG in cell_tags(c)]
    if len(found) != 1:
        raise ValueError(f"{name}: {len(found)} cells tagged {PARAMETERS_TAG!r}, not one")
    unknown = sorted(set(parameters) - assigned_names(cell_source(cells[found[0]])))
    if unknown:
        raise ValueError(f"{name}: the parameters cell does not define {unknown}")
    lines = []
    for key, value in parameters.items():
        text = repr(value)
        try:
            ast.literal_eval(text)
        except ValueError as e:
            raise ValueError(f"{name}: parameter {key}={text} is not a literal") from e
        lines.append(f"{key} = {text}")
    injected = {"cell_type": "code", "execution_count": None, "id": INJECTED_TAG,
                "metadata": {"tags": [INJECTED_TAG]}, "outputs": [],
                "source": "\n".join(lines)}
    return {**nb, "cells": cells[:found[0] + 1] + [injected] + cells[found[0] + 1:]}


def _matplotlib(plots):
    """pyplot on the Agg backend, or None where the plot cells are left out."""
    if plots is False:
        return None
    try:
        matplotlib = importlib.import_module("matplotlib")
    except ImportError:
        if plots:
            raise
        return None
    matplotlib.use("Agg")
    return importlib.import_module("matplotlib.pyplot")


def run_notebook(path, parameters=None, plots=None) -> dict:
    """Run the code cells of the notebook at ``path`` in order in one
    namespace and return it. ``namespace["__notebook__"]`` records the cells
    run and the plot cells run and left out."""
    path = pathlib.Path(path)
    nb = read_notebook(path)
    if parameters:
        nb = inject_parameters(nb, parameters, path.name)
    plt = _matplotlib(plots)
    cells = [c for c in nb["cells"] if c["cell_type"] == "code"]
    record = {"path": str(path), "cells_run": 0, "plot_cells_run": 0,
              "plot_cells_left_out": 0}
    ns = {"__name__": "__main__", "__notebook__": record}
    for index, cell in enumerate(nb["cells"]):
        if cell["cell_type"] != "code":
            continue
        is_plot = PLOT_TAG in cell_tags(cell)
        if is_plot and plt is None:
            record["plot_cells_left_out"] += 1
            continue
        try:
            exec(compile(cell_source(cell), f"{path.name}[cell {index}]", "exec"), ns)
        except BaseException as e:
            e.add_note(f"raised in {path.name}, cell {index}")
            raise
        finally:
            if plt is not None:
                plt.close("all")
        record["cells_run"] += 1
        record["plot_cells_run"] += is_plot
    if record["plot_cells_left_out"]:
        print(f"{path.name}: left out {record['plot_cells_left_out']} of "
              f"{sum(PLOT_TAG in cell_tags(c) for c in cells)} plot cells "
              f"({'plots=False' if plots is False else 'matplotlib is not installed'})",
              flush=True)
    return ns


if __name__ == "__main__":
    for arg in sys.argv[1:]:
        t0 = time.perf_counter()
        run_notebook(arg)
        print(f"{arg}: {time.perf_counter() - t0:.2f} s wall", flush=True)
