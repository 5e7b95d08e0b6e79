#!/usr/bin/env python3
"""Generate the port's API reference (docs/api_torch/*.md) from docstrings.

The port's counterpart of ``scripts/gen_api_docs.py``, with its own copy
of the page generator: it walks every public module of
``snn_for_object_detection_tpu_torch`` (those with no JAX counterpart
too), reads signatures and docstrings, and writes one markdown page per
module plus an index. The pages are committed;
``tests/test_torch_docs.py`` fails if they drift from the code.

Importing the modules builds nothing: the CUDA kernels and the native
rasterizer are compiled at their first use, never at import.

Run from the repo root:  python scripts/gen_api_docs_torch.py
"""

from __future__ import annotations

import importlib
import inspect
import os
import pkgutil
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PACKAGE = "snn_for_object_detection_tpu_torch"
OUT_DIR = os.path.join("docs", "api_torch")
# a default value's repr that names a memory address or the checkout's
# directory changes from run to run and from checkout to checkout; the
# page shows the object without the address and the path from <repo>
_ADDRESS = re.compile(r" at 0x[0-9a-f]+")


def public_modules() -> list:
    """Every module of the package (not the packages' ``__init__``)
    whose dotted name has no part that starts with an underscore (so not
    ``__main__``, which runs the CLI), in sorted order."""
    pkg = importlib.import_module(PACKAGE)
    names = [info.name for info in pkgutil.walk_packages(
        pkg.__path__, PACKAGE + ".") if not info.ispkg]
    return sorted(n for n in names
                  if not any(p.startswith("_") for p in n.split(".")))


def _clean_doc(obj) -> str:
    doc = inspect.getdoc(obj)
    if not doc:
        return ""
    lines, params = [], []
    for line in doc.splitlines():
        s = line.strip()
        # light RST-field -> markdown-bullet conversion
        if s.startswith(":param "):
            name, _, rest = s[len(":param "):].partition(":")
            params.append(f"- **{name.strip()}** — {rest.strip()}")
        elif s.startswith(":type ") or s.startswith(":rtype:"):
            continue
        elif s.startswith(":return:") or s.startswith(":returns:"):
            params.append(f"- **returns** — {s.split(':', 2)[2].strip()}")
        elif s.startswith(":raises "):
            name, _, rest = s[len(":raises "):].partition(":")
            params.append(f"- **raises {name.strip()}** — {rest.strip()}")
        else:
            lines.append(line)
    out = "\n".join(lines).rstrip()
    if params:
        out += "\n\n" + "\n".join(params)
    return out


def _signature(obj) -> str:
    try:
        return _ADDRESS.sub("", str(inspect.signature(obj))).replace(
            ROOT, "<repo>")
    except (ValueError, TypeError):
        return "(...)"


def _is_public(name: str) -> bool:
    return not name.startswith("_")


def _document_class(cls, md: list) -> None:
    md.append(f"### `class {cls.__name__}`\n")
    bases = [b.__name__ for b in cls.__bases__ if b is not object]
    if bases:
        md.append(f"*Bases: {', '.join(bases)}*\n")
    doc = _clean_doc(cls)
    if doc:
        md.append(doc + "\n")
    if "__init__" in cls.__dict__:
        md.append(f"```python\n{cls.__name__}{_signature(cls.__init__)}\n```\n")
    for name, member in sorted(vars(cls).items()):
        if not _is_public(name) or name == "__init__":
            continue
        if isinstance(member, (staticmethod, classmethod)):
            member = member.__func__
        if inspect.isfunction(member):
            md.append(f"#### `{cls.__name__}.{name}{_signature(member)}`\n")
        elif isinstance(member, property):
            md.append(f"#### `{cls.__name__}.{name}` *(property)*\n")
        else:
            continue
        mdoc = _clean_doc(member)
        if mdoc:
            md.append(mdoc + "\n")


def document_module(modname: str) -> str:
    mod = importlib.import_module(modname)
    md = [f"# `{modname}`\n"]
    mdoc = _clean_doc(mod)
    if mdoc:
        md.append(mdoc + "\n")
    members = sorted(vars(mod).items())
    classes = [o for n, o in members if _is_public(n) and inspect.isclass(o)
               and o.__module__ == modname]
    # any public non-class callable defined here (an autograd Function's
    # apply, a functools.partial with a module, ...)
    functions = [(n, o) for n, o in members
                 if _is_public(n) and callable(o) and not inspect.isclass(o)
                 and not inspect.ismodule(o)
                 and getattr(o, "__module__", None) == modname]
    if classes:
        md.append("## Classes\n")
        for cls in classes:
            _document_class(cls, md)
    if functions:
        md.append("## Functions\n")
        for name, fn in functions:
            md.append(f"### `{name}{_signature(fn)}`\n")
            fdoc = _clean_doc(fn)
            if fdoc:
                md.append(fdoc + "\n")
    return "\n".join(md).rstrip() + "\n"


def page_name(modname: str) -> str:
    return modname.split(".", 1)[1].replace(".", "_") + ".md"


def generate() -> dict:
    """Return {path relative to the repo root: content} for every page."""
    pages = {}
    index = [
        "# API reference — the PyTorch + CUDA port\n",
        f"Generated from the docstrings of `{PACKAGE}` by "
        "`scripts/gen_api_docs_torch.py`; the JAX package's reference is "
        "`docs/api/index.md`.\n",
    ]
    by_pkg: dict = {}
    for modname in public_modules():
        fname = page_name(modname)
        pages[os.path.join(OUT_DIR, fname)] = document_module(modname)
        by_pkg.setdefault(modname.split(".")[1], []).append((modname, fname))
    for pkg, entries in by_pkg.items():
        index.append(f"## `{pkg}`\n")
        for modname, fname in entries:
            index.append(f"- [`{modname.split('.', 1)[1]}`]({fname})")
        index.append("")
    pages[os.path.join(OUT_DIR, "index.md")] = "\n".join(index).rstrip() + "\n"
    return pages


def main():
    pages = generate()
    os.makedirs(os.path.join(ROOT, OUT_DIR), exist_ok=True)
    for path, content in pages.items():
        with open(os.path.join(ROOT, path), "w") as f:
            f.write(content)
    print(f"wrote {len(pages)} pages under {OUT_DIR}/")


if __name__ == "__main__":
    main()
