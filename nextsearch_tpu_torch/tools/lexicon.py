"""lexicon CLI: invert forward.bin into barrelized lexicon + postings.

Stage 2 of the offline index build (reference: src/lexicon.cpp:16-152): read
forward.bin + terms.bin, invert to per-term postings sorted by docId, and
write barrels.bin + 64x {lexicon_bNNN.bin, inverted_bNNN.bin}.

Usage: python -m nextsearch_tpu_torch.tools.lexicon <SEGMENT_DIR>
"""

from __future__ import annotations

import sys
from pathlib import Path

from ..index.segmentio import load_forward_stage, write_segment


def run(segment_dir: str) -> int:
    seg_dir = Path(segment_dir)
    if not (seg_dir / "forward.bin").exists() or not (seg_dir / "terms.bin").exists():
        print(f"Missing forward.bin or terms.bin in: {seg_dir}", file=sys.stderr)
        return 1
    seg = load_forward_stage(seg_dir)
    write_segment(seg, seg_dir, barrels=True, stages="inverted")
    print(f"Built BARRELIZED lexicon+inverted in: {seg_dir}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 1:
        print(
            "Usage: python -m nextsearch_tpu_torch.tools.lexicon <SEGMENT_DIR>",
            file=sys.stderr,
        )
        return 1
    return run(argv[0])


if __name__ == "__main__":
    sys.exit(main())
