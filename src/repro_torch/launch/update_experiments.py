"""Inject the dry-run summary + roofline table into markdown markers.

  PYTHONPATH=src python -m repro_torch.launch.update_experiments \
      build/dryrun.json [EXPERIMENTS.md]

The port's copy of ``repro.launch.update_experiments``: the text between
``<!-- DRYRUN-SUMMARY -->`` / ``<!-- ROOFLINE-TABLE -->`` and their
closing markers is replaced (or the bare opening marker expanded).
"""

from __future__ import annotations

import re
import sys

from repro_torch.launch import report


def inject(md_path: str, marker: str, content: str) -> None:
    with open(md_path) as f:
        text = f.read()
    tag = f"<!-- {marker} -->"
    block = f"{tag}\n{content}\n<!-- /{marker} -->"
    if f"<!-- /{marker} -->" in text:
        text = re.sub(
            rf"<!-- {marker} -->.*?<!-- /{marker} -->", block, text,
            flags=re.S)
    else:
        text = text.replace(tag, block)
    with open(md_path, "w") as f:
        f.write(text)


def main() -> None:
    json_path = sys.argv[1]
    md_path = sys.argv[2] if len(sys.argv) > 2 else "EXPERIMENTS.md"
    inject(md_path, "DRYRUN-SUMMARY", report.summarize(json_path))
    inject(md_path, "ROOFLINE-TABLE", report.render(json_path))
    print(f"updated {md_path} from {json_path}")


if __name__ == "__main__":
    main()
