"""Fixtures of the benchmark's own tests (run: ``python -m pytest gabench/tests``).

Tests that need a CUDA card carry the ``card`` marker and take the ``card``
fixture, which skips them where there is none: the decision is made inside
the test, never while the module is imported.
"""

import json
import pathlib
import shutil
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# the small cells the CPU tests run: the real configurations' settings on a
# genome of 30 kb at 20x, in core and forced out of core
TINY_GENOME = {"length": 30000, "repeats": [{"length": 1500, "copies": 3}]}
TINY_CELLS = {"tiny": 3 << 30, "tinyooc": 1 << 20}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def add_tiny_cells(root: pathlib.Path) -> None:
    """Add the tiny configurations, a 20x traffic mix and their cells to the
    benchmark at root, as a later change would: new files and new entries."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    base = json.loads((root / "gabench/configs/ecoli_mg1655.json").read_text())
    for name, outofcore in TINY_CELLS.items():
        config = dict(base, name=name, genome=TINY_GENOME)
        config["pipeline"] = dict(base["pipeline"], batch_reads=1024, outofcore_bytes=outofcore)
        (root / f"gabench/configs/{name}.json").write_text(json.dumps(config))
        spec["workloads"].append({"name": f"{name}.cov20", "config": name, "traffic": "cov20",
                                  "chips": 1, "why": "a test cell"})
    traffic = json.loads((root / "gabench/traffic/hiseq50.json").read_text())
    (root / "gabench/traffic/cov20.json").write_text(json.dumps(dict(traffic, coverage=20)))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of the benchmark (BENCHMARK.json and gabench/) with the tiny
    cells added."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "gabench", root / "gabench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    add_tiny_cells(root)
    return root
