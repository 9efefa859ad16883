#!/usr/bin/env bash
# Full CI: the complete test suite in all engine-mode legs.
#
#   leg 1 (default): key64 u64-key engine — the library default, running
#                    WITHOUT the process-global x64 flag (the engine creates
#                    its u64 dtypes under a trace-local jax.enable_x64).
#   leg 2 (u32):     the u32 three-operand engine (LINKPRED_KEY64=0).
#   leg 3 (x64):     key64 engine again under process-global JAX_ENABLE_X64
#                    (conftest enables it when LINKPRED_KEY64=1) — pins the
#                    x64-interplay regressions.
#
# The engine mode is call state (scoring.py::default_key64), so every leg
# gives its engine the full oracle/differential/mesh coverage.
set -euo pipefail
cd "$(dirname "$0")/.."

echo "=== CI leg 1/3: key64 engine (library default, no global x64) ==="
python -m pytest tests/ -x -q "$@"

echo "=== CI leg 2/3: u32 engine (LINKPRED_KEY64=0) ==="
LINKPRED_KEY64=0 python -m pytest tests/ -x -q "$@"

echo "=== CI leg 3/3: key64 engine under global x64 ==="
LINKPRED_KEY64=1 python -m pytest tests/ -x -q "$@"
