"""docs/port.md stays a true map of the port (string checks only).

- every `.py` module of `src/repro_torch/` has a row naming it beside its
  counterpart in `src/repro/` (which must exist), or beside "port only"
  where the reference has none;
- every kernel `mmad.cu` defines (`__global__`), one per route of `mmad`
  and the fp8 route's transpose, is named.
"""
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_MD = ROOT / "docs" / "port.md"
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py"))
# each `__global__` declaration's name: the first call-like word up to its
# body that is not `__launch_bounds__(...)` or a `sizeof` inside it
KERNELS = [next(w for w in re.findall(r"(\w+)\s*\(", decl)
                if w not in ("__launch_bounds__", "sizeof"))
           for decl in re.findall(
               r"__global__([^{]*)\{",
               (PORT / "kernels" / "csrc" / "mmad.cu").read_text())]


def _row(module: str) -> str:
    rows = [line for line in PORT_MD.read_text().splitlines()
            if line.startswith(f"| `repro_torch/{module}` |")]
    assert len(rows) == 1, f"docs/port.md has {len(rows)} rows for {module}"
    return rows[0]


@pytest.mark.parametrize("module", MODULES)
def test_every_port_module_is_mapped(module):
    row = _row(module)
    reference = ROOT / "src" / "repro" / module
    if reference.exists():
        assert f"`repro/{module}`" in row
    else:
        assert "port only" in row


def test_every_mmad_route_is_named():
    assert KERNELS == ["mmad_rows_kernel", "mmad_cols_kernel",
                       "mmad_wgmma_kernel", "mmad_fp8_kernel",
                       "mmad_fp8_transpose_kernel", "mmad_tile_kernel"]
    text = PORT_MD.read_text()
    for kernel in KERNELS:
        assert f"`{kernel}`" in text, kernel
