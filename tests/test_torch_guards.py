"""Guards on the PyTorch port that hold with no card present.

* No module of ``src/repro_torch/`` and not ``chip_smoke.py`` imports
  ``jax`` or the reference package ``repro`` (not even its jax-free
  modules: importing any ``repro.core`` module runs the package's
  ``__init__``, which imports jax).
* Entry points default to the card: without ``device="cpu"`` they raise
  when no card is present, instead of running the plain versions.
* A kernel wrapper handed CPU tensors raises instead of running its twin.
* Every kernel that ``PERF.md`` lists as ported has its CUDA source.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.engine import LSMEngine
from repro_torch.core.policies import TieringPolicy
from repro_torch.core.scheduler import FairScheduler
from repro_torch.kernels.bloom.bloom import PROBE, bloom_probe_multi_cuda
from repro_torch.kernels.merge.merge import MERGE, merge_path_merge_age_cuda

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module or "")
    return out


def _port_files() -> list[Path]:
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_reference():
    files = _port_files()
    assert len(files) > 15
    bad = {str(f.relative_to(ROOT)): sorted(m for m in _imports(f)
                                             if m.split(".")[0] in
                                             ("jax", "jaxlib", "repro"))
           for f in files}
    assert not {f: m for f, m in bad.items() if m}


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LSMEngine(TieringPolicy(3, 64, 1024), FairScheduler())
    eng = LSMEngine(TieringPolicy(3, 64, 1024), FairScheduler(),
                    device="cpu")
    assert eng.device.type == "cpu"


@pytest.mark.parametrize("kw", [{"wal": object()}, {"faults": object()},
                                {"indexes": ("ix",)}])
def test_later_slices_raise(kw):
    with pytest.raises(NotImplementedError, match="later slice"):
        LSMEngine(TieringPolicy(3, 64, 1024), FairScheduler(),
                  device="cpu", **kw)


def test_kernel_wrappers_refuse_cpu_tensors():
    probe0, merge0 = PROBE.launches, MERGE.launches
    filts = torch.zeros((2, 8), dtype=torch.int32)
    meta = np.array([[128, 1], [256, 3]], np.uint32)
    keys = torch.arange(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        bloom_probe_multi_cuda(filts, meta, keys)
    run = torch.zeros(128, dtype=torch.int32)
    parts = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        merge_path_merge_age_cuda(run, run, run, run, run, run, parts, 64)
    assert (PROBE.launches, MERGE.launches) == (probe0, merge0)


def test_ported_kernels_have_cuda_sources():
    perf = (ROOT / "PERF.md").read_text()
    rows = [ln for ln in perf.splitlines()
            if ln.startswith("|") and re.search(r"\bported\b", ln)]
    sources = [m for ln in rows
               for m in re.findall(r"src/repro_torch/csrc/[\w.]+\.cu", ln)]
    assert len(sources) >= 2, rows
    for src in sources:
        text = (ROOT / src).read_text()
        assert "__global__" in text and "Replaces:" in text, src
