"""UTF-8 hygiene checker (dev tooling; reference check_encoding.py analog).

Scans text files for invalid UTF-8, BOMs, and mojibake markers; writes an
optional JSON report.

Usage:
  python -m realtime_analytics_tpu_torch.scripts.check_encoding [root] [--report out.json]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

TEXT_SUFFIXES = {
    ".py", ".md", ".yaml", ".yml", ".json", ".js", ".css", ".html", ".sh",
    ".txt", ".toml", ".cfg",
}
# written as escapes so this file does not flag itself
MOJIBAKE_MARKERS = (
    "\ufffd",            # replacement char
    "\u00c3\u00a9",      # utf-8 e-acute read as latin-1
    "\u00c3\u00a8",      # utf-8 e-grave read as latin-1
    "\u00e2\u0080\u0099",  # utf-8 right-quote read as latin-1
    "\u00e2\u0080\u009c",  # utf-8 left-double-quote read as latin-1
)
SKIP_DIRS = {".git", "__pycache__", ".pytest_cache", "node_modules", ".jax_cache"}


def scan(root: Path) -> dict:
    report = {"checked": 0, "issues": []}
    for path in sorted(root.rglob("*")):
        if any(part in SKIP_DIRS for part in path.parts):
            continue
        if not path.is_file() or path.suffix.lower() not in TEXT_SUFFIXES:
            continue
        report["checked"] += 1
        raw = path.read_bytes()
        rel = str(path.relative_to(root))
        if raw.startswith(b"\xef\xbb\xbf"):
            report["issues"].append({"file": rel, "issue": "utf8-bom"})
            raw = raw[3:]
        try:
            text = raw.decode("utf-8")
        except UnicodeDecodeError as exc:
            report["issues"].append(
                {"file": rel, "issue": f"invalid-utf8 at byte {exc.start}"}
            )
            continue
        for marker in MOJIBAKE_MARKERS:
            if marker in text:
                report["issues"].append(
                    {"file": rel, "issue": f"mojibake marker {marker!r}"}
                )
                break
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("root", nargs="?", default=".")
    p.add_argument("--report", default=None)
    args = p.parse_args(argv)
    report = scan(Path(args.root))
    if args.report:
        Path(args.report).write_text(json.dumps(report, indent=2))
    print(f"checked {report['checked']} files, {len(report['issues'])} issue(s)")
    for issue in report["issues"]:
        print(f"  {issue['file']}: {issue['issue']}")
    return 1 if report["issues"] else 0


if __name__ == "__main__":
    sys.exit(main())
