"""doclint: keep the docs tree honest (dead links + rotting snippets).

The port's own copy of ``repro/analysis/doclint.py`` (the port imports
nothing of the JAX package).  Two checks over markdown files, both
import-light (stdlib only; a checked snippet may import what it needs):

1. **Link check** — every relative link and ``#anchor`` in ``docs/*.md``
   and ``README.md`` must resolve: the target file exists inside the
   repo, and when the link carries an anchor the target heading exists
   (GitHub's heading→anchor slug rules).  External ``http(s)://`` /
   ``mailto:`` links and paths escaping the repo (e.g. the CI badge's
   site-relative URL) are skipped.
2. **Doctest extraction** — fenced ````python`` blocks containing
   ``>>>`` prompts are collected per file and executed with
   :mod:`doctest` (one shared namespace per file, in block order), so a
   quickstart in ``docs/ARCHITECTURE.md`` breaks CI the moment the API
   it shows drifts.

CLI::

    python -m repro_torch.analysis.doclint README.md docs --doctest docs/ARCHITECTURE.md

Exit status 1 on any dead link/anchor or failing doctest.
"""
from __future__ import annotations

import argparse
import doctest
import re
import sys
from pathlib import Path
from typing import Iterable, List, Tuple

_LINK_RE = re.compile(r"\[[^\]]*\]\(([^)\s]+)(?:\s+\"[^\"]*\")?\)")
_HEADING_RE = re.compile(r"^(#{1,6})\s+(.*)$")
_FENCE_RE = re.compile(r"^(```|~~~)")
_PY_BLOCK_RE = re.compile(r"```python[^\n]*\n(.*?)```", re.S)


def slugify(heading: str) -> str:
    """GitHub's heading→anchor slug: demote to lowercase, strip markup
    and punctuation (keeping word chars, hyphens, spaces), then replace
    spaces with hyphens.

    Args:
      heading: the heading text (without the leading ``#`` marks).

    Returns:
      The anchor slug (no leading ``#``).
    """
    text = re.sub(r"`([^`]*)`", r"\1", heading)            # code spans
    text = re.sub(r"\[([^\]]*)\]\([^)]*\)", r"\1", text)    # links → text
    # asterisks never reach a GitHub anchor; bare underscores are word
    # chars and DO survive (BENCH_PR*.json -> bench_prjson)
    text = re.sub(r"\*", "", text)
    text = text.strip().lower()
    text = re.sub(r"[^\w\- ]", "", text)
    return text.replace(" ", "-")


def anchors_of(md_path: Path) -> set:
    """All anchor slugs a markdown file exposes (fenced blocks skipped;
    GitHub-style ``-1``/``-2`` suffixes for duplicate headings)."""
    seen: dict = {}
    out = set()
    in_fence = False
    for line in md_path.read_text().splitlines():
        if _FENCE_RE.match(line.strip()):
            in_fence = not in_fence
            continue
        if in_fence:
            continue
        m = _HEADING_RE.match(line)
        if not m:
            continue
        slug = slugify(m.group(2))
        n = seen.get(slug, 0)
        seen[slug] = n + 1
        out.add(slug if n == 0 else f"{slug}-{n}")
    return out


def iter_links(md_path: Path) -> Iterable[str]:
    """Yield every inline link target in a markdown file, fenced code
    blocks excluded."""
    in_fence = False
    for line in md_path.read_text().splitlines():
        if _FENCE_RE.match(line.strip()):
            in_fence = not in_fence
            continue
        if in_fence:
            continue
        for m in _LINK_RE.finditer(line):
            yield m.group(1)


def check_links(md_files: List[Path], repo_root: Path) -> List[str]:
    """Resolve every relative link/anchor in ``md_files``.

    Args:
      md_files: the markdown files to lint.
      repo_root: links resolving outside this directory are skipped
        (site-relative badge URLs etc.).

    Returns:
      Human-readable failure strings (empty = clean).
    """
    failures = []
    for md in md_files:
        for target in iter_links(md):
            if re.match(r"^[a-z][a-z0-9+.-]*:", target):   # http:, mailto:
                continue
            path_part, _, anchor = target.partition("#")
            if not path_part:                               # in-page #anchor
                if anchor and anchor not in anchors_of(md):
                    failures.append(f"{md}: dead in-page anchor #{anchor}")
                continue
            dest = (md.parent / path_part).resolve()
            try:
                dest.relative_to(repo_root.resolve())
            except ValueError:
                continue                                    # escapes repo
            if not dest.exists():
                failures.append(f"{md}: dead link {target}")
                continue
            if anchor and dest.suffix == ".md":
                if anchor not in anchors_of(dest):
                    failures.append(
                        f"{md}: dead anchor {target} "
                        f"(no heading slugs to '{anchor}' in {dest.name})")
    return failures


def run_doctests(md_path: Path) -> Tuple[int, int]:
    """Execute the ``>>>`` snippets of one markdown file.

    All ``python`` fenced blocks containing doctest prompts are joined
    (in order, sharing one namespace) and run.

    Returns:
      ``(failed, attempted)`` example counts; ``(0, 0)`` when the file
      has no doctest blocks.
    """
    blocks = [b for b in _PY_BLOCK_RE.findall(md_path.read_text())
              if ">>>" in b]
    if not blocks:
        return 0, 0
    src = "\n".join(blocks)
    test = doctest.DocTestParser().get_doctest(
        src, {}, md_path.name, str(md_path), 0)
    runner = doctest.DocTestRunner(optionflags=doctest.ELLIPSIS)
    runner.run(test)
    res = runner.summarize(verbose=False)
    return res.failed, res.attempted


def collect(paths: List[str]) -> List[Path]:
    """Expand file/dir arguments into a sorted list of ``*.md`` files."""
    out = []
    for p in paths:
        pp = Path(p)
        if pp.is_dir():
            out.extend(sorted(pp.rglob("*.md")))
        else:
            out.append(pp)
    return out


def main(argv=None) -> int:
    """CLI entry point; returns the process exit status."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.doclint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="+",
                    help="markdown files and/or directories to link-check")
    ap.add_argument("--doctest", action="append", default=[],
                    metavar="MD", help="also run the >>> snippets of this "
                    "markdown file (repeatable)")
    ap.add_argument("--root", default=".",
                    help="repo root; links escaping it are skipped")
    args = ap.parse_args(argv)

    md_files = collect(args.paths)
    failures = check_links(md_files, Path(args.root))
    for f in failures:
        print(f"doclint: {f}", file=sys.stderr)
    print(f"doclint: {len(md_files)} file(s), "
          f"{len(failures)} dead link(s)/anchor(s)")
    rc = 1 if failures else 0
    for md in args.doctest:
        failed, attempted = run_doctests(Path(md))
        print(f"doclint: {md}: {attempted} doctest example(s), "
              f"{failed} failed")
        if failed:
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
