"""backup_data CLI: zip runtime state (caches, stats, feedback, .env).

Reference: scripts/backup_data.cpp:40-139 (shells out to zip/tar; we use
zipfile). Usage: python -m nextsearch_tpu_torch.tools.backup_data [OUT_ZIP] [DIR]
"""

from __future__ import annotations

import sys
import time
import zipfile
from pathlib import Path

DEFAULT_ITEMS = (
    "search_cache.json",
    "ai_overview_cache.json",
    "ai_summary_cache.json",
    "feedback.json",
    "stats.json",
    ".env",
)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    out = Path(argv[0]) if argv else Path(
        f"backup_{time.strftime('%Y%m%d_%H%M%S')}.zip"
    )
    base = Path(argv[1]) if len(argv) > 1 else Path(".")
    added = 0
    with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as z:
        for item in DEFAULT_ITEMS:
            p = base / item
            if p.exists():
                z.write(p, item)
                added += 1
    print(f"Backed up {added} files to {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
