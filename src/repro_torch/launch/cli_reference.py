"""Generated CLI reference of the port: one markdown table per entry-point
parser.

Port of ``repro.launch.cli_reference``. Every user-facing CLI of the port
keeps its argparse surface in a ``build_parser()`` function (an import
with no side effect), and this module renders them into
``docs/CLI_torch.md`` (``docs/CLI.md`` is the reference's).

    PYTHONPATH=src python -m repro_torch.launch.cli_reference --write
    PYTHONPATH=src python -m repro_torch.launch.cli_reference --check

``--check`` exits non-zero if the file drifts from the parsers
(``tests/test_torch_cli_reference.py`` runs the same comparison), so a new
flag cannot land without its docs.
"""
from __future__ import annotations

import argparse
import re
from importlib import import_module
from pathlib import Path

# the port's tools in the order of the reference's file; each module
# imports without touching torch.distributed, a card or os.environ
TOOLS = (
    "repro_torch.launch.train",
    "repro_torch.launch.dryrun",
    "repro_torch.launch.serve",
    "repro_torch.topo.planner",
    "repro_torch.obs.calibrate",
)

HEADER = """\
# CLI reference of the PyTorch port

<!-- GENERATED FILE — do not edit by hand.
     Regenerate: PYTHONPATH=src python -m repro_torch.launch.cli_reference --write
     Drift-checked by tests/test_torch_cli_reference.py and --check. -->

Every tool below exposes its parser as ``build_parser()`` in the named
module; this file is rendered from those parsers, so it cannot drift from
``--help`` (a test compares the two). Defaults shown as ``off`` are
``store_true`` switches. The JAX package's tools are in ``docs/CLI.md``.
"""


def _escape(text: str) -> str:
    return re.sub(r"\s+", " ", text or "").replace("|", "\\|").strip()


def _fmt_default(action) -> str:
    d = action.default
    if isinstance(d, bool):
        return "on" if d else "off"
    if d is None or d == argparse.SUPPRESS:
        return ""
    if isinstance(d, (list, tuple)):
        return "`" + ",".join(str(x) for x in d) + "`"
    if d == "":
        return ""
    return f"`{d}`"


def _row(action) -> str:
    flags = ", ".join(f"`{s}`" for s in action.option_strings) \
        or f"`{action.dest}`"
    desc = _escape(action.help or "")
    if action.choices is not None:
        ch = "one of: " + ", ".join(f"`{c}`" for c in action.choices)
        desc = f"{desc} ({ch})" if desc else ch
    return f"| {flags} | {_fmt_default(action)} | {desc} |"


def render_tool(module: str) -> str:
    ap = import_module(module).build_parser()
    lines = [f"## `python -m {module}`", ""]
    if ap.description:
        lines += [_escape(ap.description), ""]
    lines += ["| flag | default | description |", "| --- | --- | --- |"]
    for action in ap._actions:
        if isinstance(action, argparse._HelpAction):
            continue
        lines.append(_row(action))
    return "\n".join(lines) + "\n"


def generate() -> str:
    return HEADER + "\n" + "\n".join(render_tool(m) for m in TOOLS)


def default_path() -> Path:
    # src/repro_torch/launch/cli_reference.py -> repo root -> docs/
    return Path(__file__).resolve().parents[3] / "docs" / "CLI_torch.md"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(default_path()))
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--write", action="store_true",
                      help="(re)generate the reference file")
    mode.add_argument("--check", action="store_true",
                      help="exit 1 if the file drifts from the parsers")
    args = ap.parse_args(argv)
    out = Path(args.out)
    text = generate()
    if args.write:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(text)
        print(f"wrote {out} ({len(TOOLS)} tools)")
        return 0
    if not out.exists():
        print(f"{out}: missing — run with --write")
        return 1
    if out.read_text() != text:
        print(f"{out}: stale — a parser changed; run with --write")
        return 1
    print(f"{out}: up to date")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
