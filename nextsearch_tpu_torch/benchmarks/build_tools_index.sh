#!/bin/bash
# The tools-built index that bench_tools.py measures: the product's CLI
# pipeline (make_synthetic -> forwardindex -> lexicon) of the port.
#   bash nextsearch_tpu_torch/benchmarks/build_tools_index.sh [ROOT] [N_DOCS]
# ROOT defaults to $NEXTSEARCH_TOOLS_ROOT, else <temp dir>/nextsearch_tools_1m;
# N_DOCS to 1000000 (vocabulary 200000, seed 4). Run from the repository root.
set -e
ROOT=${1:-${NEXTSEARCH_TOOLS_ROOT:-${TMPDIR:-/tmp}/nextsearch_tools_1m}}
N=${2:-1000000}
SEG=$ROOT/index/segments/seg_000001
if [ ! -f "$SEG/barrels.bin" ]; then
  mkdir -p "$ROOT" "$SEG"
  echo "[tools] make_synthetic..." >&2
  python -m nextsearch_tpu_torch.tools.make_synthetic "$ROOT/corpus" --n "$N" --vocab 200000 --seed 4
  echo "[tools] forwardindex..." >&2
  python -m nextsearch_tpu_torch.tools.forwardindex "$ROOT/corpus" "$SEG"
  echo "[tools] lexicon..." >&2
  python -m nextsearch_tpu_torch.tools.lexicon "$SEG"
fi
echo "[tools] done" >&2
ls -la "$SEG" | head -5
